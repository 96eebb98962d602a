"""Device meshes over ``torch.distributed`` ranks (port of ``diffpir_tpu/parallel``):
``mesh`` (meshes and sharding), ``collectives`` (what GSPMD would insert),
``tp`` (Megatron-style UNet sharding) and ``multihost`` (process bootstrap,
input shards, the multi-process dry run)."""

from diffpir_tpu_torch.parallel.mesh import make_mesh, replicate, shard_batch

__all__ = ["make_mesh", "shard_batch", "replicate"]
