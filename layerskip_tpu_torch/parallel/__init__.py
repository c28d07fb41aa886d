"""Inference parallelism over ``torch.distributed`` (port of
``layerskip_tpu/parallel``): process-group setup, meshes, the sharding
rules and the collectives the layer functions issue."""
