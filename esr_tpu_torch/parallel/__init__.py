"""Parallelism over ``torch.distributed``: data (``parallel.mesh``), tensor
(``parallel.tensor``) and context (``parallel.context``)."""
