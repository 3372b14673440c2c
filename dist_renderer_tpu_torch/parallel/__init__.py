"""Multi-process rendering and fitting on torch.distributed: the device
mesh (mesh.py), the sharded renders and fit step (sharding.py) and their
runners across ranks (dryrun.py)."""
