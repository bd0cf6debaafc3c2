"""Serving launcher: batched generation over a (smoke) model.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \
        --requests 16 --max-new 16 [--device cuda|cpu] [--via-flows]

Requests are accumulated by the BatchAccumulator (arrival-window batching)
and served in generation batches; aggregate throughput is printed.  Runs on
CUDA unless ``--device cpu`` is given.  ``--via-flows`` routes the batches
through a published flow (one Compute action over the control plane's copy,
``repro_torch.core``), analysis-as-a-service (paper §2.1.4) over the serving
fabric; a flow run that does not succeed raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import configs, resolve_device
from repro_torch.models.model import Model
from repro_torch.serve.engine import BatchAccumulator, ServeEngine


def serve_via_flows(accum: BatchAccumulator, max_new: int):
    """Flushes ``accum`` inside a one-state flow (FlowsService ->
    ap://compute) and waits for it.  Returns the finished run, whose
    ``context["served"]`` holds the compute action's result: the number of
    requests served.  The engine is shut down."""
    from repro_torch.core.actions import ActionRegistry
    from repro_torch.core.engine import PollingPolicy
    from repro_torch.core.flows_service import FlowsService
    from repro_torch.core.providers import ComputeProvider

    registry = ActionRegistry()
    compute = ComputeProvider()
    registry.register(compute)
    flows = FlowsService(
        registry,
        polling=PollingPolicy(initial_seconds=0.02, use_callbacks=True),
    )
    eid = compute.register_endpoint("serving")
    fid = compute.register_function(lambda: [len(accum.flush(max_new))], name="serve_batch")
    record = flows.publish_flow(
        {"StartAt": "Serve", "States": {"Serve": {
            "Type": "Action", "ActionUrl": "ap://compute",
            "Parameters": {"endpoint_id": eid, "function_id": fid, "kwargs": {}},
            "ResultPath": "$.served", "End": True}}},
        title="Serve batch",
    )
    run = flows.run_flow(record.flow_id, {})
    flows.engine.wait(run.run_id, timeout=600)
    flows.engine.shutdown()
    return run


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--arch", default="internlm2-1.8b")
    parser.add_argument("--requests", type=int, default=16)
    parser.add_argument("--prompt-len", type=int, default=16)
    parser.add_argument("--max-new", type=int, default=16)
    parser.add_argument("--max-batch", type=int, default=8)
    parser.add_argument("--via-flows", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = configs.get(args.arch, smoke=True)
    model = Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(0), device=device)
    engine = ServeEngine(model, params, max_len=args.prompt_len + args.max_new,
                         device=device)
    accum = BatchAccumulator(engine, max_batch=args.max_batch)

    rng = np.random.default_rng(0)
    t0 = time.time()
    for _ in range(args.requests):
        accum.submit(rng.integers(0, cfg.vocab_size, size=args.prompt_len))

    if args.via_flows:
        run = serve_via_flows(accum, args.max_new)
        print(f"flow run {run.run_id}: {run.status}")
        if run.status != "SUCCEEDED":
            raise RuntimeError(f"flow run {run.run_id} {run.status}: {run.error}")
        results_count = run.context["served"]["details"]["results"][0]
    else:
        results_count = len(accum.flush(args.max_new))

    dt = time.time() - t0
    print(f"served {results_count} requests in {dt:.2f}s on {device} "
          f"({engine.stats['tokens_generated']} tokens, "
          f"{engine.stats['tokens_generated']/max(dt,1e-9):.1f} tok/s)")
    print("engine stats:", engine.stats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
