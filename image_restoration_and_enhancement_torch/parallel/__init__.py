"""Multi-device serving and training on torch.distributed: meshes, collectives,
tensor parallelism, height (spatial) sharding, and what a serving or training
rank runs. See each module."""
