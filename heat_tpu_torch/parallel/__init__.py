"""Sequence parallelism and the distributed sort (reference:
``heat_tpu/parallel/``): ring attention, the sample sort and exact order
statistics."""

from .ring_attention import ring_attention, ring_self_attention, sequence_lengths
from .sample_sort import first_occurrence_mask, order_statistics_1d, sample_sort_1d

__all__ = ["first_occurrence_mask", "order_statistics_1d", "ring_attention", "ring_self_attention",
           "sample_sort_1d", "sequence_lengths"]
