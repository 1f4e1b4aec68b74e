"""Data, context and tensor parallelism over `torch.distributed`: the
(data, model[, seq]) grid of ranks (`mesh.py`), the differentiable
exchanges between them (`comm.py`), the sequence-parallel scans
(`seq_scan.py`) and the tensor-parallel split of the parameters
(`sharding.py`)."""
