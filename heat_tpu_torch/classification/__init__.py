"""Classification (reference: ``heat_tpu/classification/``)."""

from .kneighborsclassifier import KNeighborsClassifier
