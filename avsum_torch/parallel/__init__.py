"""Parallel training over ``torch.distributed`` (``avsum_tpu/parallel``):
the mesh (:mod:`.mesh`), process startup (:mod:`.multihost`), the
collectives and their autograd forms (:mod:`.comm`), ring attention
(:mod:`.ring`) and the GPipe schedule (:mod:`.pipeline`)."""
