"""Parallelism on ``torch.distributed`` (``diff_foley_tpu/parallel/``)."""
