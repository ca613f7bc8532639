"""Data scalers (reference: ``heat_tpu/preprocessing/``)."""

from .preprocessing import MaxAbsScaler, MinMaxScaler, Normalizer, RobustScaler, StandardScaler
