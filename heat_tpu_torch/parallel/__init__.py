"""Sequence and pipeline parallelism, the distributed sort, halos and the
ring (reference: ``heat_tpu/parallel/``): ring attention, GPipe's
schedule, the sample sort and exact order statistics, the halo exchange
and ``ring_map``."""

from . import halo
from . import pipeline
from . import ring
from .halo import halo_exchange, with_halos
from .pipeline import pipeline_apply
from .ring import ring_map
from .ring_attention import ring_attention, ring_self_attention, sequence_lengths
from .sample_sort import first_occurrence_mask, order_statistics_1d, sample_sort_1d

__all__ = ["first_occurrence_mask", "halo_exchange", "order_statistics_1d", "pipeline_apply", "ring_attention",
           "ring_map",
           "ring_self_attention", "sample_sort_1d", "sequence_lengths", "with_halos"]
