"""Sequence parallelism (reference: ``heat_tpu/parallel/``): ring attention."""

from .ring_attention import ring_attention, ring_self_attention, sequence_lengths

__all__ = ["ring_attention", "ring_self_attention", "sequence_lengths"]
