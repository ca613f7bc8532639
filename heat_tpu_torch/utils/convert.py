"""Carry state over from the JAX package, through numpy only.

``kmeans_from_reference`` turns a fitted ``heat_tpu`` KMeans's attributes,
given as numpy values, into a fitted estimator of this package whose
``predict`` gives the reference's labels.  ``transformer_lm_from_reference``
and ``multihead_attention_from_reference`` turn a reference parameter
pytree (nested dicts and lists of numpy arrays, as ``init`` makes it) into a
module of this package that computes the same function; ``to_reference``
gives a module's pytree back.  A pytree path maps to
the module's parameter name by joining its keys with dots
(``blocks[0]["mha"]["out_proj"]["weight"]`` is ``blocks.0.mha.out_proj.weight``);
the empty entries of parameter-free layers (``GELU``'s ``()``) have none.
Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..cluster.kmeans import KMeans
from ..nn.attention import MultiheadAttention
from ..nn.models import TransformerLM
from ..core import factories
from ..core.communication import Communication
from ..core.dndarray import DNDarray

__all__ = [
    "array_from_numpy",
    "kmeans_from_reference",
    "multihead_attention_from_reference",
    "to_reference",
    "transformer_lm_from_reference",
]


def array_from_numpy(global_np: np.ndarray, split: Optional[int], comm: Optional[Communication] = None,
                     device=None) -> DNDarray:
    """A DNDarray of the GLOBAL numpy array, this rank keeping its chunk of ``split``."""
    return factories.array(np.asarray(global_np), split=split, comm=comm, device=device)


def kmeans_from_reference(state: Dict[str, np.ndarray], device=None) -> KMeans:
    """A fitted KMeans from ``cluster_centers_``, ``labels_``, ``inertia_`` and
    ``n_iter_`` of a fitted reference estimator (numpy arrays and scalars);
    ``labels_`` is split along axis 0 over the default communicator."""
    centers = np.asarray(state["cluster_centers_"])
    labels = array_from_numpy(np.asarray(state["labels_"]).astype(np.int32), 0, device=device)
    km = KMeans(n_clusters=centers.shape[0], init=centers)
    c = torch.tensor(centers, device=labels.larray.device)
    km._set_fitted(c.float(), c.dtype, labels, labels.larray, float(state["inertia_"]), int(state["n_iter_"]))
    return km


def _flatten(tree, prefix=()) -> Dict[str, np.ndarray]:
    """{dotted path: array} of a reference parameter pytree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {".".join(map(str, prefix)): np.asarray(tree)}
    flat = {}
    for key, sub in items:
        flat.update(_flatten(sub, prefix + (key,)))
    return flat


def _unflatten(flat: Dict[str, np.ndarray]):
    """The pytree of {dotted path: array}: numeric keys are list positions,
    and a position without parameters is ``()``."""
    root: dict = {}
    for key, value in flat.items():
        parts = [int(p) if p.isdigit() else p for p in key.split(".")]
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(isinstance(k, int) for k in node):
            return [node.get(i, ()) for i in range(max(node) + 1)]
        return node

    return listify(root)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # numpy has no bfloat16 of its own: go through float32, exactly
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _load(module: torch.nn.Module, params) -> torch.nn.Module:
    """Copy the pytree into the module's parameters; every name must match."""
    module.load_state_dict({k: _tensor(v) for k, v in _flatten(params).items()}, strict=True)
    return module


def to_reference(module: torch.nn.Module):
    """The module's parameters as a reference pytree of numpy arrays
    (bfloat16 as float32): the inverse of the ``*_from_reference`` functions."""
    return _unflatten({name: p.detach().cpu().float().numpy() if p.dtype == torch.bfloat16
                       else p.detach().cpu().numpy() for name, p in module.named_parameters()})


def transformer_lm_from_reference(params, **config) -> TransformerLM:
    """A ``TransformerLM(**config)`` holding the reference ``TransformerLM``'s
    parameters ``params`` (embed, pos, blocks[ln1, mha, ln2, ff], ln_f, head,
    as numpy arrays); ``config`` is the constructor's keywords, ``device``
    included.  It computes the reference's function."""
    return _load(TransformerLM(**config), params)


def multihead_attention_from_reference(params, **config) -> MultiheadAttention:
    """A ``MultiheadAttention(**config)`` holding the reference module's
    parameters (in_proj_weight, in_proj_bias, out_proj)."""
    return _load(MultiheadAttention(**config), params)
