"""Sequence and pipeline parallelism, the distributed sort, halos, the ring
and the serving tier (reference: ``heat_tpu/parallel/``): ring attention,
GPipe's schedule, the sample sort and exact order statistics, the halo
exchange, ``ring_map``, and the runtime plane's supervisor, scheduler,
serving executors and federation."""

from . import halo
from . import pipeline
from . import ring
from .halo import halo_exchange, with_halos
from .pipeline import pipeline_apply
from .ring import ring_map
from .ring_attention import ring_attention, ring_self_attention, sequence_lengths
from .sample_sort import first_occurrence_mask, order_statistics_1d, sample_sort_1d
from . import supervisor
from .supervisor import Supervisor, SupervisorResult
from . import scheduler
from .scheduler import Job, JobJournal, JobRejected, JournalSchemaError, Scheduler
from . import serving
from .serving import make_executor
from . import federation
from .federation import AdmissionPredictor, Federation, WorldHandle

__all__ = ["AdmissionPredictor", "Federation", "Job", "JobJournal", "JobRejected", "JournalSchemaError",
           "Scheduler", "Supervisor", "SupervisorResult", "WorldHandle", "federation", "first_occurrence_mask",
           "halo_exchange", "make_executor", "order_statistics_1d", "pipeline_apply", "ring_attention",
           "ring_map", "ring_self_attention", "sample_sort_1d", "scheduler", "sequence_lengths", "serving",
           "supervisor", "with_halos"]
