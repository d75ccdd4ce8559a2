"""Many image pairs at once: `batch.stylize_batch` (the port's counterpart
of `dpst_tpu/parallel/`, on one device; the multi-GPU mesh and the spatial
sharding are not ported yet)."""
