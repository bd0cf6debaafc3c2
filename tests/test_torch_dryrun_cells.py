"""Every SMOKE cell of the port's dry-run traces (``repro_torch.launch.dryrun``).

``run_cell`` ends ``ok`` for train, prefill and decode of every arch of
``configs.REFERENCE_ARCH_IDS`` at SMOKE configs and tiny shapes on a fake (16, 16)
world, the production mesh's shape (the reference's ``dryrun --all`` cell
list, cut to SMOKE), and for xLSTM also on (1, 1) and (2, 4).  A cell that
does not trace is an error record and fails here.  Exact checks: the
status, the mesh, positive FLOPs, bytes and memory, and collectives on
every mesh of more than one rank.

The 512-rank (2, 16, 16) world is left to the card (``chip_smoke.py``
phase 12, ``python -m repro_torch.launch.dryrun --all``): a SMOKE train
step does not finish tracing on it within minutes on a small CPU box.

Run alone: ``PYTHONPATH=src python -m pytest -q tests/test_torch_dryrun_cells.py``
(about 80 s; it needs torch, not JAX).  Its own file, so that ``--dist
loadfile`` gives it a worker of its own.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

TINY = {"train": ShapeConfig("train_4k", "train", seq_len=32, global_batch=4),
        "prefill": ShapeConfig("prefill_32k", "prefill", seq_len=32, global_batch=2),
        "decode": ShapeConfig("decode_32k", "decode", seq_len=32, global_batch=2)}
KINDS = tuple(TINY)
CELLS = ([(arch, kind, (16, 16)) for arch in configs.REFERENCE_ARCH_IDS for kind in KINDS]
         + [("xlstm-1.3b", kind, mesh) for mesh in ((1, 1), (2, 4)) for kind in KINDS])


@pytest.fixture
def smoke(monkeypatch):
    """``run_cell`` builds each arch's SMOKE config."""
    get = configs.get
    monkeypatch.setattr(configs, "get", lambda arch, smoke=True: get(arch, smoke=True))


@pytest.mark.parametrize("arch,kind,mesh_shape", CELLS,
                         ids=[f"{a}-{k}-{m[0]}x{m[1]}" for a, k, m in CELLS])
def test_run_cell_smoke(smoke, arch, kind, mesh_shape):
    """``ok`` with positive FLOPs, bytes and memory; on more than one rank
    the params are sharded, so the step has collectives.  xLSTM on (2, 4)
    and (16, 16) needs its chunk and time loops per shard, its norms over
    whole rows and its FFN input in its rules' placement (ROADMAP F6);
    whisper's prefill its caches on the mesh (F7)."""
    shape = TINY[kind]
    rec = dryrun.run_cell(arch, shape.name, "single", device="cpu", shape=shape,
                          mesh_shape=mesh_shape, save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    chips = mesh_shape[0] * mesh_shape[1]
    assert rec["mesh_shape"] == list(mesh_shape) and rec["chips"] == chips
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes accessed"] > 0
    assert rec["memory"]["argument_size_in_bytes"] > 0
    assert rec["memory"]["temp_size_in_bytes"] > 0
    assert (rec["collectives"]["_total"]["count"] > 0) == (chips > 1)
    assert rec["hlo_instructions"] > 0 and rec["lower_seconds"] > 0
    assert not torch.distributed.is_initialized()
