"""One module per kind of cell (``"driver"`` in a cell file)."""
