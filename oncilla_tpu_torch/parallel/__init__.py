"""The fabric of device rows (mesh order and the row arena) and the
training meshes: named axes over the processes of a ``torch.distributed``
world, their collectives, ring attention and the GPipe executor."""
