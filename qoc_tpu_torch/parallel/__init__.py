"""The seed-batched layer (port of ``qoc_tpu.parallel``, without its
mesh): ``batch`` (the public entry points), ``mega_batch`` (kernel 6),
``chain_batch`` (kernels 4 and 5), ``cols_batch`` (plain torch)."""
