"""The seed-batched layer (port of ``qoc_tpu.parallel``): ``batch`` (the
public entry points), ``mega_batch`` (kernel 6), ``chain_batch`` (kernels
4 and 5), ``cols_batch`` (plain torch, and the sharded config-5 runner),
``mesh`` (the device mesh, one process per device) and ``shard`` (the
explicit sharded step with its reduced statistics)."""
