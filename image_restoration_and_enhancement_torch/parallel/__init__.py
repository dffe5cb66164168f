"""Multi-device serving on torch.distributed: meshes, collectives, tensor
parallelism and height (spatial) sharding. See each module."""
