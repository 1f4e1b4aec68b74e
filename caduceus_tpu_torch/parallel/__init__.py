"""Data and context parallelism over `torch.distributed`: the (data,
model) grid of ranks (`mesh.py`), the differentiable exchanges between
them (`comm.py`) and the sequence-parallel scans (`seq_scan.py`)."""
