"""Many pairs and big images over a device mesh: `mesh` (the mesh, the
placement helpers, the ambient mesh of `use_mesh`), `batch.stylize_batch`
(pairs split over the mesh's batch axis) and `spatial.stylize_spatial`
(one image's rows sharded with explicit halo exchanges): the port's
counterpart of `dpst_tpu/parallel/`."""
