"""Partitioning rules for parameters, optimizer moments, batches and caches
(port of ``repro.dist.sharding``).

Everything here produces :class:`PartitionSpec` trees (or :class:`Sharding`
trees via :func:`shardings_for`); the rules touch no process group, so a
stand-in mesh with a ``shape`` mapping serves them as a real
``DeviceMesh`` does.

A spec is a tuple of per-dim entries, the port's stand-in for JAX's
``PartitionSpec``: ``None`` (replicated), one axis name, or a tuple of
axis names that shard one dim together, major to minor.

Design rules (the reference's):

* **Proposals, then legalization.**  The per-leaf rules *propose* a layout
  (Megatron-style column / row splits of projections, vocab-split
  embeddings, batch / heads splits of GEAR cache buffers); every proposal
  passes through :func:`fit_spec`, which checks divisibility against the
  leaf's shape and the mesh and migrates / shrinks / drops axes that do not
  fit.
* **Layout, not semantics.**  A spec says where each process keeps its
  share of a leaf; the training step computes the values of the unsharded
  step whatever the layout, so migrating a split to another dim is always
  safe.

Trees are the port's: ``named_parameters()`` names (``blocks.3.wq``), one
tensor a layer.  The reference stacks each pattern position's layers on a
leading dim R; every rule addresses trailing dims, so a port leaf gets the
reference's spec with the R entry dropped, except where the reference's
legalization moves an axis onto R (hymba-1.5b's full ``w_bcdt`` [1600, 825]
on a 16-way model axis: the reference's lands on R, the port's on 1600).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import torch

from repro_torch.launch.mesh import MODEL, axis_sizes, dp_axes

__all__ = [
    "PartitionSpec",
    "P",
    "Sharding",
    "fit_spec",
    "param_pspecs",
    "zero1_pspecs",
    "batch_pspecs",
    "cache_pspecs",
    "shardings_for",
]


class PartitionSpec(tuple):
    """Per-dim mesh-axis entries of one leaf: ``P("model", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


# ---------------------------------------------------------------------------
# Spec legalization


def _axes_of(entry) -> tuple[str, ...]:
    """Normalize one spec entry to a tuple of axis names."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def _entry_of(axes: tuple[str, ...]):
    if not axes:
        return None
    if len(axes) == 1:
        return axes[0]
    return axes


def _longest_fitting_prefix(axes: tuple[str, ...], dim: int,
                            mesh_shape: dict) -> tuple[str, ...]:
    """Longest prefix of ``axes`` whose combined size divides ``dim``.

    A zero-size dim divides everything (0 % n == 0): sharding an empty dim
    is legal and free.
    """
    for end in range(len(axes), 0, -1):
        prefix = axes[:end]
        if dim % math.prod(mesh_shape[a] for a in prefix) == 0:
            return prefix
    return ()


def fit_spec(pspec: Sequence, shape: Sequence[int], mesh, *,
             migrate: bool = True) -> PartitionSpec:
    """Legalize ``pspec`` against a concrete ``shape`` on ``mesh``.

    For each sharded dim whose size the assigned mesh axes do not divide:

    1. keep the longest prefix of the axis group that still divides the dim
       (a multi-axis group degrades gracefully instead of all-or-nothing),
    2. migrate the remaining axes to the first unsharded dim they divide
       (unless ``migrate=False``),
    3. drop whatever still does not fit (replicate).

    Axis names absent from the mesh are dropped up front; specs shorter
    than ``len(shape)`` are padded with ``None``.
    """
    mesh_shape = axis_sizes(mesh)
    entries = [_axes_of(e) for e in tuple(pspec)]
    if len(entries) > len(shape):
        raise ValueError(f"spec {pspec} has more entries than shape {tuple(shape)}")
    entries += [()] * (len(shape) - len(entries))
    entries = [tuple(a for a in e if a in mesh_shape) for e in entries]

    out: list[tuple[str, ...]] = [()] * len(shape)
    used: set[str] = set()
    homeless: list[tuple[str, ...]] = []
    for i, axes in enumerate(entries):
        if not axes:
            continue
        keep = _longest_fitting_prefix(axes, shape[i], mesh_shape)
        out[i] = keep
        used.update(keep)
        rest = axes[len(keep):]
        if rest:
            homeless.append(rest)

    if migrate:
        queue = list(homeless)
        while queue:
            axes = tuple(a for a in queue.pop(0) if a not in used)
            if not axes:
                continue
            free = [i for i in range(len(shape)) if not out[i]]
            # prefer a dim that takes the whole group, else the best prefix
            target, placed = None, ()
            for i in free:
                fit = _longest_fitting_prefix(axes, shape[i], mesh_shape)
                if fit == axes:
                    target, placed = i, fit
                    break
                if len(fit) > len(placed):
                    target, placed = i, fit
            if target is None or not placed:
                continue
            out[target] = placed
            used.update(placed)
            rest = axes[len(placed):]
            if rest:  # a partially-placed group keeps looking for a home
                queue.append(rest)

    return P(*[_entry_of(e) for e in out])


# ---------------------------------------------------------------------------
# Parameter rules


# Column-split projections: shard the output features (last dim) over MODEL.
_COL_SPLIT = {
    "wq", "wk", "wv", "wg", "wr",          # attention / rwkv time-mix
    "w_up", "w_gate",                       # mlp + moe expert up/gate
    "w_in", "w_bcdt",                       # ssm in-projections
    "mix_lora_a",                           # rwkv token-shift lora
    "lm_head",
}
# Row-split projections: shard the input features (second-to-last dim) over
# MODEL, so the matmul contracts over the sharded dim (Megatron pairing).
_ROW_SPLIT = {"wo", "w_down", "w_out"}


def _param_rule(names: list[str], shape: tuple[int, ...]) -> list:
    """Propose per-dim mesh axes for one parameter leaf, by its last name
    (and its parent's, for RWKV6's ``cm.wv``), on its trailing dims."""
    name = names[-1] if names else ""
    parent = names[-2] if len(names) > 1 else ""
    nd = len(shape)
    ent: list = [None] * nd
    if nd < 2:
        return ent  # norms, biases, per-head scalars: replicate
    if name == "embed":
        ent[nd - 2] = MODEL  # vocab dim ([V, d] text, [K, V, d] audio)
        return ent
    # rwkv channel-mix wv is the down projection [ff, d] (wv elsewhere is a
    # column-split attention projection).
    row = name in _ROW_SPLIT or (parent == "cm" and name == "wv")
    if row:
        ent[nd - 2] = MODEL
    elif name in _COL_SPLIT:
        ent[nd - 1] = MODEL
    return ent


def _named_shapes(params) -> dict:
    """``{name: shape}`` of a module's ``named_parameters()``, or of a
    mapping of names to tensors or shapes."""
    items = params.named_parameters() if isinstance(params, torch.nn.Module) else params.items()
    return {n: tuple(getattr(t, "shape", t)) for n, t in items}


def param_pspecs(cfg, params: Any, mesh) -> dict:
    """Model-parallel spec of every parameter, by name.

    Attention / MLP projections get Megatron column / row splits, MoE expert
    stacks split on the expert hidden dim, embeddings on the vocab dim, each
    legalized against the leaf's shape, so ragged dims (prime vocab, few kv
    heads) fall back to a divisible dim or replication.
    """
    del cfg  # rules are name/shape driven; cfg kept for API stability
    return {n: fit_spec(P(*_param_rule(n.split("."), s)), s, mesh)
            for n, s in _named_shapes(params).items()}


def zero1_pspecs(cfg, params: Any, mesh) -> dict:
    """ZeRO-1 specs for optimizer moments: the parameter's spec plus a split
    over the data-parallel axes (``pod`` folds into DP) on its largest
    replicated dim that they divide, so AdamW's moments cost ``1/|dp|`` of
    the replicated baseline.  Leaves with no divisible dim keep the
    parameter's spec."""
    base = param_pspecs(cfg, params, mesh)
    dp = dp_axes(mesh)
    if not dp:
        return base
    dp_size = math.prod(axis_sizes(mesh)[a] for a in dp)
    out = {}
    for n, s in _named_shapes(params).items():
        entries = [_axes_of(e) for e in tuple(base[n])]
        entries += [()] * (len(s) - len(entries))
        free = [i for i, e in enumerate(entries) if not e]
        for i in sorted(free, key=lambda i: -s[i]):
            if s[i] % dp_size == 0 and s[i] > 0:
                entries[i] = tuple(dp)
                break
        out[n] = fit_spec(P(*[_entry_of(e) for e in entries]), s, mesh, migrate=False)
    return out


# ---------------------------------------------------------------------------
# Batch + cache rules


def batch_pspecs(cfg, batch: dict, mesh) -> dict:
    """Shard every batch leaf's leading (batch) dim over the DP axes."""
    del cfg
    dp = dp_axes(mesh)
    out = {}
    for k, leaf in batch.items():
        ent = [None] * leaf.dim()
        if dp and leaf.dim():
            ent[0] = tuple(dp)
        out[k] = fit_spec(P(*ent), tuple(leaf.shape), mesh, migrate=False)
    return out


def cache_pspecs(cfg, caches: list, mesh, batch: int) -> list:
    """GEAR-aware layouts of the serving cache: one entry per layer, a
    ``{field: spec}`` dict of its cache's ``tensors()`` (a hybrid layer's
    (GEAR cache, SSM state) pair gives a pair of dicts).

    A leaf's batch dim (its first, ``[B, H, ...]``) shards over the DP axes
    and, where its second dim is the kv-head count, that dim over MODEL
    (the reference's rule on ``[R, B, H, ...]`` with R dropped).
    ``migrate=False``: where a dim does not divide (2 kv heads on a 4-way
    model axis) the leaf is replicated on that dim, so layouts stay uniform
    across policies.  Per-slot ``length`` [B] stays replicated, as the
    reference's [R, B] does.
    """
    dp = dp_axes(mesh)
    kv_heads = cfg.num_kv_heads

    def spec(shape):
        ent: list = [None] * len(shape)
        if len(shape) >= 2 and shape[0] == batch:
            if dp:
                ent[0] = tuple(dp)
            if len(shape) >= 3 and shape[1] == kv_heads:
                ent[1] = MODEL
        return fit_spec(P(*ent), shape, mesh, migrate=False)

    def layer(part):
        if isinstance(part, tuple):
            return tuple(layer(p) for p in part)
        return {f: spec(tuple(t.shape)) for f, t in part.tensors().items()}

    return [layer(c) for c in caches]


# ---------------------------------------------------------------------------
# Spec -> sharding


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A spec on a ``DeviceMesh`` (the twin of ``NamedSharding``): which
    slice of a global tensor this process holds.  An entry naming several
    axes shards its dim over them major to minor, in mesh order."""

    mesh: Any
    spec: PartitionSpec

    def __post_init__(self):
        order = list(axis_sizes(self.mesh))
        for e in self.spec:
            idx = [order.index(a) for a in _axes_of(e)]
            if idx != sorted(idx):
                raise ValueError(f"spec entry {e!r} is not in the mesh's axis order {order}")

    @property
    def placements(self) -> tuple:
        """Per mesh dim, the DTensor placement that spells this layout:
        ``Shard(d)`` where the axis shards tensor dim d, else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        dims = {a: d for d, e in enumerate(self.spec) for a in _axes_of(e)}
        return tuple(Shard(dims[a]) if a in dims else Replicate() for a in axis_sizes(self.mesh))

    def _live(self, entry) -> tuple[str, ...]:
        """The axes of ``entry`` that split anything (size > 1)."""
        sizes = axis_sizes(self.mesh)
        return tuple(a for a in _axes_of(entry) if sizes[a] > 1)

    @property
    def trivial(self) -> bool:
        """True when every process holds the whole tensor."""
        return not any(self._live(e) for e in self.spec)

    def same_slices(self, other: "Sharding") -> bool:
        """True when both layouts give every process the same slice."""
        n = max(len(self.spec), len(other.spec))
        pad = (None,) * n
        return all(self._live(a) == other._live(b)
                   for a, b in zip(tuple(self.spec) + pad, tuple(other.spec) + pad))

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This process's slice of the global ``full`` (a view)."""
        from repro_torch.dist.compat import axis_index
        sizes = axis_sizes(self.mesh)
        out = full
        for d, e in enumerate(self.spec):
            axes = self._live(e)
            if not axes:
                continue
            n = math.prod(sizes[a] for a in axes)
            block = 0
            for a in axes:
                block = block * sizes[a] + axis_index(self.mesh, a)
            width = full.shape[d] // n
            out = out.narrow(d, block * width, width)
        return out

    def full(self, local: torch.Tensor, axes: Sequence[str] | None = None) -> torch.Tensor:
        """The global tensor from every process's ``local`` slice (gathered
        over the sharding axes; only over ``axes`` when given, which
        undoes just their split).  Every process of the axes' groups must
        call it."""
        from repro_torch.dist.compat import all_gather_cat
        out = local.detach().contiguous()
        for d, e in enumerate(self.spec):
            for a in reversed(self._live(e)):      # minor axis first
                if axes is None or a in axes:
                    out = all_gather_cat(out, self.mesh, a, d)
        return out


def shardings_for(mesh, pspecs: Any) -> Any:
    """Map a spec tree (dicts, lists and tuples of :class:`PartitionSpec`)
    to a :class:`Sharding` tree on ``mesh``."""
    if isinstance(pspecs, PartitionSpec):
        return Sharding(mesh, pspecs)
    if isinstance(pspecs, dict):
        return {k: shardings_for(mesh, v) for k, v in pspecs.items()}
    if isinstance(pspecs, (list, tuple)):
        return type(pspecs)(shardings_for(mesh, v) for v in pspecs)
    if pspecs is None:
        return None
    raise TypeError(f"shardings_for: not a spec tree: {type(pspecs).__name__}")
