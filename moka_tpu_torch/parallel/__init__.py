"""Parallelism (port of ``moka_tpu/parallel/``): the process groups and the
("data", "fsdp", "model") mesh (``mesh``), the collectives and how each
group moves its tensors (``comm``), the sharding rule table and the
per-rank slices of the frozen base (``sharding``), the per-layer fetch of
a sharded or host-resident base (``stream``), context-parallel ring
attention (``ring_attention``) and tensor parallelism on the ``model``
axis (``tensor``)."""
