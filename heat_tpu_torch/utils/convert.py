"""Carry state over from the JAX package, through numpy only.

``kmeans_from_reference`` turns a fitted ``heat_tpu`` KMeans's attributes,
given as numpy values, into a fitted estimator of this package whose
``predict`` gives the reference's labels.  ``transformer_lm_from_reference``
and ``multihead_attention_from_reference`` turn a reference parameter
pytree (nested dicts and lists of numpy arrays, as ``init`` makes it) into a
module of this package that computes the same function; ``to_reference``
gives a module's pytree back.  A grouped-query model's packed projection,
``in_proj_weight`` of (E + 2·num_kv_heads·head_dim, E), carries over as it
is: the module built from the same ``num_kv_heads`` has that shape.  A pytree path maps to
the module's parameter name by joining its keys with dots
(``blocks[0]["mha"]["out_proj"]["weight"]`` is ``blocks.0.mha.out_proj.weight``);
the empty entries of parameter-free layers (``GELU``'s ``()``) have none.
The other estimators carry over the same way, each from its fitted
attributes as numpy values: ``kmedians_from_reference``,
``kmedoids_from_reference``, ``batchparallel_from_reference``,
``pca_from_reference``, ``incremental_pca_from_reference``,
``dmd_from_reference``, ``lasso_from_reference``,
``gaussiannb_from_reference``, ``knn_from_reference`` and
``scaler_from_reference``, so that ``predict``/``transform`` are held on
identical state.
``mlp_from_reference`` and ``resnet_from_reference`` do the same for the
vision models: Sequential lists, ``Residual``'s ``body``/``shortcut``, and
BatchNorm's ``running_*`` leaves into the module's buffers (``to_reference``
gives them back).  ``daso_from_reference`` takes the reference DASO's
parameters stacked over its groups: rank r loads group r // ici.
The layers and models of the nn surface carry over the same way:
``load_reference(module, params)`` for any module built with the
reference's configuration (its parameter names are the reference's
pytree paths), and by name ``moe_from_reference``,
``transformer_decoder_from_reference``, ``seq2seq_from_reference`` and
``recurrent_from_reference``.  Every loader cuts the expert leaves of a
sharded ``MoE`` (``comm=`` over p ranks) to this rank's E/p experts.
``pipelined_from_reference`` takes the reference ``Pipelined``'s leaves
stacked over the depth and keeps this rank's stage; ``to_reference`` of a
``Pipelined`` stacks its blocks' leaves back.
Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import classification, cluster, decomposition, naive_bayes, preprocessing, regression
from ..cluster.kmeans import KMeans
from ..nn import models, recurrent
from ..nn.attention import MultiheadAttention
from ..nn.models import Seq2SeqTransformer, TransformerLM
from ..nn.moe import MoE
from ..nn.pipelined import Pipelined
from ..core import factories
from ..core.communication import Communication
from ..core.dndarray import DNDarray

__all__ = [
    "array_from_numpy",
    "batchparallel_from_reference",
    "dmd_from_reference",
    "gaussiannb_from_reference",
    "incremental_pca_from_reference",
    "kmedians_from_reference",
    "kmedoids_from_reference",
    "knn_from_reference",
    "lasso_from_reference",
    "pca_from_reference",
    "scaler_from_reference",
    "daso_from_reference",
    "kmeans_from_reference",
    "load_reference",
    "moe_from_reference",
    "pipelined_from_reference",
    "recurrent_from_reference",
    "seq2seq_from_reference",
    "transformer_decoder_from_reference",
    "mlp_from_reference",
    "resnet_from_reference",
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


def _kcluster_from_reference(est, state: Dict[str, np.ndarray], device=None):
    centers = np.asarray(state["cluster_centers_"])
    labels = array_from_numpy(np.asarray(state["labels_"]).astype(np.int32), 0, device=device)
    c = torch.tensor(centers, device=labels.larray.device)
    est._set_fitted(c.float(), c.dtype, labels, labels.larray, float(state.get("inertia_", 0.0)),
                    int(state.get("n_iter_", 0)))
    return est


def kmedians_from_reference(state: Dict[str, np.ndarray], device=None) -> "cluster.KMedians":
    """A fitted KMedians from a reference KMedians' ``cluster_centers_``,
    ``labels_``, ``inertia_`` and ``n_iter_``."""
    centers = np.asarray(state["cluster_centers_"])
    return _kcluster_from_reference(cluster.KMedians(n_clusters=centers.shape[0], init=centers), state, device)


def kmedoids_from_reference(state: Dict[str, np.ndarray], device=None) -> "cluster.KMedoids":
    """A fitted KMedoids from a reference KMedoids' attributes (as KMedians)."""
    centers = np.asarray(state["cluster_centers_"])
    return _kcluster_from_reference(cluster.KMedoids(n_clusters=centers.shape[0], init=centers), state, device)


def batchparallel_from_reference(state: Dict[str, np.ndarray], median: bool = False, device=None):
    """A fitted BatchParallelKMeans (or, with ``median``, KMedians) from the
    reference's ``cluster_centers_``, ``labels_`` and ``n_iter_``."""
    centers = np.asarray(state["cluster_centers_"])
    cls = cluster.BatchParallelKMedians if median else cluster.BatchParallelKMeans
    est = cls(n_clusters=centers.shape[0])
    labels = array_from_numpy(np.asarray(state["labels_"]).astype(np.int32), 0, device=device)
    est._set_centers(torch.tensor(centers, device=labels.larray.device), labels)
    est._labels, est._n_iter = labels, int(state.get("n_iter_", 0))
    return est


def _rep(a, device=None, comm=None) -> DNDarray:
    return factories.array(np.asarray(a), split=None, device=device, comm=comm)


def pca_from_reference(state: Dict[str, np.ndarray], device=None) -> "decomposition.PCA":
    """A fitted PCA from the reference's ``components_``, ``mean_``,
    ``singular_values_``, ``explained_variance_`` and
    ``explained_variance_ratio_``."""
    est = decomposition.PCA(n_components=int(np.asarray(state["components_"]).shape[0]))
    for key in ("components_", "mean_", "singular_values_", "explained_variance_", "explained_variance_ratio_"):
        setattr(est, key, _rep(state[key], device))
    est.n_components_ = est.components_.shape[0]
    est.total_explained_variance_ratio_ = float(np.sum(state["explained_variance_ratio_"]))
    return est


def incremental_pca_from_reference(state: Dict[str, np.ndarray], device=None) -> "decomposition.IncrementalPCA":
    """A fitted IncrementalPCA from the reference's ``components_``,
    ``singular_values_``, ``mean_`` and ``n_samples_seen_``; its sketch
    Σ·Vᵀ is rebuilt from them, so ``partial_fit`` goes on from there."""
    comps = np.asarray(state["components_"])
    est = decomposition.IncrementalPCA(n_components=comps.shape[0])
    for key in ("components_", "singular_values_", "mean_"):
        setattr(est, key, _rep(state[key], device))
    est.n_samples_seen_ = int(state["n_samples_seen_"])
    est._us = est.singular_values_.larray[:, None] * est.components_.larray
    return est


def dmd_from_reference(state: Dict[str, np.ndarray], device=None) -> "decomposition.DMD":
    """A fitted DMD from the reference's ``rom_basis_``,
    ``rom_transfer_matrix_``, ``rom_eigenvalues_``, ``rom_eigenmodes_`` and
    ``dmdmodes_``; the basis and modes split 0 over the default
    communicator."""
    est = decomposition.DMD()
    est.rom_basis_ = array_from_numpy(state["rom_basis_"], 0, device=device)
    est.dmdmodes_ = array_from_numpy(np.asarray(state["dmdmodes_"]).astype(np.complex64), 0, device=device)
    est.rom_transfer_matrix_ = _rep(state["rom_transfer_matrix_"], device)
    for key in ("rom_eigenvalues_", "rom_eigenmodes_"):
        setattr(est, key, _rep(np.asarray(state[key]).astype(np.complex64), device))
    est.n_modes_ = est.rom_basis_.shape[1]
    return est


def lasso_from_reference(state: Dict[str, np.ndarray], device=None) -> "regression.Lasso":
    """A fitted Lasso from the reference's ``theta`` ((d + 1, 1), the
    intercept first) and ``n_iter_``."""
    est = regression.Lasso()
    est._Lasso__theta = _rep(np.asarray(state["theta"], dtype=np.float32).reshape(-1, 1), device)
    est.n_iter_ = int(state.get("n_iter_", 0))
    return est


def gaussiannb_from_reference(state: Dict[str, np.ndarray], device=None) -> "naive_bayes.GaussianNB":
    """A fitted GaussianNB from the reference's ``classes_``,
    ``class_count_``, ``class_prior_``, ``theta_``, ``var_`` and
    ``epsilon_``."""
    est = naive_bayes.GaussianNB()
    for key in ("classes_", "class_count_", "class_prior_", "theta_", "var_"):
        setattr(est, key, _rep(state[key], device))
    est.epsilon_ = float(state["epsilon_"])
    return est


def knn_from_reference(x_train: np.ndarray, y_train: np.ndarray, n_neighbors: int = 5,
                       device=None) -> "classification.KNeighborsClassifier":
    """A fitted KNeighborsClassifier on the reference's training rows and
    labels (split 0 over the default communicator)."""
    return classification.KNeighborsClassifier(n_neighbors).fit(array_from_numpy(x_train, 0, device=device),
                                                                 array_from_numpy(y_train, 0, device=device))


_SCALER_STATE = {"StandardScaler": ("mean_", "var_", "scale_"), "MaxAbsScaler": ("max_abs_", "scale_"),
                 "MinMaxScaler": ("data_min_", "data_max_", "data_range_", "scale_", "min_"),
                 "RobustScaler": ("center_", "scale_"), "Normalizer": ()}


def scaler_from_reference(kind: str, state: Dict[str, np.ndarray], device=None, **params):
    """A fitted scaler of class ``kind`` (``'StandardScaler'``, ...) from the
    reference's fitted statistics (None where the reference fitted none)."""
    est = getattr(preprocessing, kind)(**params)
    for key in _SCALER_STATE[kind]:
        if state.get(key) is not None:
            setattr(est, key, _rep(state[key], device))
    return est


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
    """Copy the pytree into the module's parameters; every name must match.
    A sharded ``MoE``'s expert leaves are cut to this rank's experts."""
    flat = _flatten(params)
    for name, m in module.named_modules():
        if isinstance(m, MoE) and m.local_experts != m.num_experts:
            own = slice(m.expert_offset, m.expert_offset + m.local_experts)
            for leaf in ("w1", "b1", "w2", "b2"):
                key = f"{name}.{leaf}" if name else leaf
                flat[key] = np.asarray(flat[key])[own]
    module.load_state_dict({k: _tensor(v) for k, v in flat.items()}, strict=True)
    return module


def load_reference(module: torch.nn.Module, params) -> torch.nn.Module:
    """``module`` (built with the reference module's configuration) holding
    the reference's parameter pytree ``params``; returns it."""
    return _load(module, params)


def _reference_state(module: torch.nn.Module):
    """The module's parameters and its ``running_*`` buffers (the
    reference keeps BatchNorm's running statistics in its pytree)."""
    yield from module.named_parameters()
    for name, b in module.named_buffers():
        if name.rsplit(".", 1)[-1].startswith("running_"):
            yield name, b


def to_reference(module: torch.nn.Module):
    """The module's parameters (and BatchNorm's running buffers) as a
    reference pytree of numpy arrays (bfloat16 as float32): the inverse of
    the ``*_from_reference`` functions.  A ``Pipelined``'s blocks come back
    stacked on a leading axis, the reference's layout."""
    flat = {name: p.detach().cpu().float().numpy() if p.dtype == torch.bfloat16 else p.detach().cpu().numpy()
            for name, p in _reference_state(module)}
    if isinstance(module, Pipelined):
        n = len(module.blocks)
        leaves = {k.split(".", 2)[2] for k in flat}
        flat = {k: np.stack([flat[f"blocks.{i}.{k}"] for i in range(n)]) for k in sorted(leaves)}
    return _unflatten(flat)


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


def moe_from_reference(params, **config) -> MoE:
    """An ``MoE(**config)`` holding the reference ``MoE``'s parameters
    (router, w1, b1, w2, b2 of all experts; this rank's under ``comm``)."""
    return _load(MoE(**config), params)


def transformer_decoder_from_reference(params, **config) -> torch.nn.Module:
    """``nn.models.transformer_decoder(**config)`` holding the reference
    decoder's parameters (a list of blocks)."""
    return _load(models.transformer_decoder(**config), params)


def seq2seq_from_reference(params, **config) -> Seq2SeqTransformer:
    """A ``Seq2SeqTransformer(**config)`` holding the reference model's
    parameters (src_embed, tgt_embed, pos, encoder, decoder, ln_f, head)."""
    return _load(Seq2SeqTransformer(**config), params)


_RECURRENT = ("RNN", "LSTM", "GRU", "RNNCell", "LSTMCell", "GRUCell")


def recurrent_from_reference(params, kind: str = "LSTM", **config) -> torch.nn.Module:
    """``nn.<kind>(**config)`` (RNN, LSTM, GRU or a cell) holding the
    reference layer's parameters: a list of one dict a layer, or the cell's
    dict."""
    if kind not in _RECURRENT:
        raise ValueError(f"kind must be one of {_RECURRENT}, got {kind!r}")
    return _load(getattr(recurrent, kind)(**config), params)


def pipelined_from_reference(params, block: torch.nn.Module, depth: int, comm: Optional[Communication] = None,
                             **config) -> Pipelined:
    """A ``Pipelined(block, depth, comm, **config)`` holding this rank's
    stage of the reference ``Pipelined``'s parameters, whose leaves are
    stacked over the ``depth`` blocks: rank r keeps blocks [r·depth/p,
    (r + 1)·depth/p)."""
    module = Pipelined(block, depth, comm, **config)
    n = len(module.blocks)
    first = (comm.rank if comm is not None and comm.size > 1 else 0) * n
    stacked = _flatten(params)
    return _load(module, _unflatten({f"blocks.{i}.{k}": np.asarray(v)[first + i] for k, v in stacked.items()
                                     for i in range(n)}))


def mlp_from_reference(params, sizes=(784, 256, 128, 10), device=None) -> torch.nn.Module:
    """``nn.models.mlp(sizes)`` holding the reference ``mlp``'s parameters."""
    return _load(models.mlp(sizes, device=device), params)


def resnet_from_reference(params, arch: str = "resnet", device=None, **config) -> torch.nn.Module:
    """``nn.models.<arch>(**config)`` (``'resnet'``, ``'resnet18'``,
    ``'resnet34'`` or ``'resnet50'``) holding the reference model's
    parameters and BatchNorm running statistics."""
    if arch not in ("resnet", "resnet18", "resnet34", "resnet50"):
        raise ValueError(f"arch must be resnet, resnet18, resnet34 or resnet50, got {arch!r}")
    return _load(getattr(models, arch)(device=device, **config), params)


def daso_from_reference(stacked, module: torch.nn.Module, comm: Optional[Communication] = None,
                        ici: int = 1) -> torch.nn.Module:
    """Load the reference DASO's per-group replicas (``DASO.parameters``:
    every leaf stacked over the groups) into ``module``: rank r takes group
    ``r // ici``.  Returns ``module``."""
    from ..core.communication import sanitize_comm

    g = sanitize_comm(comm).rank // int(ici)
    return _load(module, _unflatten({k: np.asarray(v)[g] for k, v in _flatten(stacked).items()}))
