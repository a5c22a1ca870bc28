"""Frame-parallel inference on ``torch.distributed`` (port of
``univst_tpu/distributed``): the mesh (:mod:`.mesh`), the explicit
collectives that XLA's partitioner derived for the JAX package
(:mod:`.comm`) and their census (:mod:`.census`)."""
