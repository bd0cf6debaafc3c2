"""Traffic generators, one module per ``kind``; the mixes are the ``.json`` files beside them."""
