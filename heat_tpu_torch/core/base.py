"""Estimator base API (reference: ``heat/core/base.py``).

sklearn-style ``fit``/``predict``/``transform`` contracts, kept as a copy of
the JAX package's stdlib-only module so that this package imports nothing
of it.
"""

from __future__ import annotations

import inspect
from typing import Dict, List

__all__ = [
    "BaseEstimator",
    "ClassificationMixin",
    "ClusteringMixin",
    "RegressionMixin",
    "TransformMixin",
    "is_classifier",
    "is_estimator",
    "is_transformer",
]


class BaseEstimator:
    @classmethod
    def _parameter_names(cls) -> List[str]:
        init = cls.__init__
        if init is object.__init__:
            return []
        sig = inspect.signature(init)
        return [p.name for p in sig.parameters.values() if p.name != "self" and p.kind != p.VAR_KEYWORD]

    def get_params(self, deep: bool = True) -> Dict[str, object]:
        """Estimator hyper-parameters as a dict (sklearn contract)."""
        params = {}
        for key in self._parameter_names():
            value = getattr(self, key, None)
            if deep and hasattr(value, "get_params"):
                for sub_key, sub_value in value.get_params().items():
                    params[f"{key}__{sub_key}"] = sub_value
            params[key] = value
        return params

    def set_params(self, **params) -> "BaseEstimator":
        if not params:
            return self
        valid = self.get_params(deep=True)
        for key, value in params.items():
            key, delim, sub_key = key.partition("__")
            if key not in valid:
                raise ValueError(f"Invalid parameter {key} for estimator {self}")
            if delim:
                getattr(self, key).set_params(**{sub_key: value})
            else:
                setattr(self, key, value)
        return self

    def __repr__(self, indent: int = 1) -> str:
        params = {
            k: (v if not hasattr(v, "larray") else "DNDarray(...)") for k, v in self.get_params(deep=False).items()
        }
        return f"{self.__class__.__name__}({params})"


def clone(estimator: BaseEstimator) -> BaseEstimator:
    """A new unfitted estimator with the same hyper-parameters."""
    return estimator.__class__(**estimator.get_params(deep=False))


class ClassificationMixin:
    _estimator_type = "classifier"

    def fit(self, x, y):
        raise NotImplementedError()

    def fit_predict(self, x, y):
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x):
        raise NotImplementedError()


class ClusteringMixin:
    _estimator_type = "clusterer"

    def fit(self, x):
        raise NotImplementedError()

    def fit_predict(self, x):
        self.fit(x)
        return self.predict(x)


class TransformMixin:
    def fit(self, x):
        raise NotImplementedError()

    def fit_transform(self, x):
        return self.fit(x).transform(x)

    def transform(self, x):
        raise NotImplementedError()


class RegressionMixin:
    _estimator_type = "regressor"

    def fit(self, x, y):
        raise NotImplementedError()

    def fit_predict(self, x, y):
        self.fit(x, y)
        return self.predict(x)

    def predict(self, x):
        raise NotImplementedError()


def is_classifier(estimator) -> bool:
    return getattr(estimator, "_estimator_type", None) == "classifier"


def is_estimator(estimator) -> bool:
    return isinstance(estimator, BaseEstimator)


def is_transformer(estimator) -> bool:
    return hasattr(estimator, "transform")
