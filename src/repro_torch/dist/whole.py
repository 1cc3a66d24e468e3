"""The whole-model module of one process on a mesh.

A process stores its shard of every parameter (``param_pspecs``).  The
forward runs on a whole-model module instead, so that attention, the MLP and
the kernels see plain tensors: :class:`WholeModel` builds it once per stored
module, sharing every parameter the layout keeps whole and holding a
gathered copy (over ``model``, or whichever axes split it) of every
parameter it splits; :meth:`WholeModel.release` drops those copies.  The
mesh train step gathers every layer at once (its backward needs them all);
the mesh serving engine gathers ``by_block``: each layer's copies as the
forward's loop over the layers reaches it, dropped when the loop moves on,
so that a process holds its shards and one layer's copies at a time.  On a
mesh whose axes all have size 1 nothing is split: the module shares every
parameter and no collective is issued.
"""

from __future__ import annotations

import collections
import contextlib
import math

import torch

from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.transformer import Transformer

__all__ = ["WholeModel", "local_module", "set_param"]


def set_param(module: torch.nn.Module, name: str, value) -> None:
    """Put ``value`` (a parameter, or None) at dotted ``name`` of ``module``."""
    owner, _, attr = name.rpartition(".")
    setattr(module.get_submodule(owner) if owner else module, attr, value)


def local_module(params: Transformer, shardings: dict) -> Transformer:
    """A module holding this process's slice of every parameter of the whole
    model ``params``: the parameter itself (shared) where ``shardings[name]``
    keeps it whole, a copy of the local slice where it splits it.  ``params``
    is left as it was."""
    out = Transformer(params.cfg, "meta")
    for n, p in params.named_parameters():
        sh = shardings[n]
        if not sh.trivial:
            p = torch.nn.Parameter(sh.local(p.detach()).clone(), requires_grad=p.requires_grad)
        set_param(out, n, p)
    return out


class _BlockByBlock(torch.nn.ModuleList):
    """A whole-model module's layers gathered one at a time: a loop over
    them gathers each layer's split parameters as it reaches the layer and
    drops them as it moves on."""

    def __init__(self, blocks: torch.nn.ModuleList, whole: "WholeModel", stored: Transformer):
        super().__init__(blocks)
        self._refs = (whole, stored)            # a tuple: not registered as submodules

    def __iter__(self):
        whole, stored = self._refs
        for i, blk in enumerate(super().__iter__()):
            whole._put(stored, whole.split_by_block[i])
            try:
                yield blk
            finally:
                whole._drop(whole.split_by_block[i])


class WholeModel:
    """Gathers a stored (sharded) module into the whole-model module the
    forward runs on.  ``shardings`` maps every parameter name to its
    :class:`~repro_torch.dist.sharding.Sharding`; a gathered copy requires
    grad when ``requires_grad`` (the train step differentiates it)."""

    def __init__(self, cfg, shardings: dict, requires_grad: bool = False):
        self.cfg, self.shardings, self.requires_grad = cfg, shardings, requires_grad
        # the split parameters in the module's order (every process must issue
        # the gathers in one order: never iterate a set of names here)
        self.split = [n for n, sh in shardings.items() if not sh.trivial]
        # the split parameters of layer i ("blocks.<i>.…"), and of none
        self.split_by_block = collections.defaultdict(list)
        self.split_outside = []
        for n in self.split:
            if n.startswith("blocks."):
                self.split_by_block[int(n.split(".")[1])].append(n)
            else:
                self.split_outside.append(n)
        self._whole = None                      # the whole-model module
        self._owner = self._by_block = None     # the stored module it shares, how it gathers

    def _put(self, stored: Transformer, names) -> None:
        for n in names:
            full = self.shardings[n].full(stored.get_parameter(n))
            set_param(self._whole, n, torch.nn.Parameter(full, requires_grad=self.requires_grad))

    def _drop(self, names) -> None:
        for n in names:
            set_param(self._whole, n, None)

    def gather(self, stored: Transformer, by_block: bool = False) -> Transformer:
        """The whole-model module of ``stored``: shared parameters where the
        layout keeps them whole, gathered copies where it splits them (every
        process of the splitting axes must call this together).
        ``by_block``: only the parameters outside the layers now, each
        layer's as a loop over ``blocks`` reaches it (the loop's order is
        the same on every process)."""
        if self._owner is not stored or self._by_block != by_block:
            self._whole = Transformer(self.cfg, "meta")
            self._owner, self._by_block = stored, by_block
            for n, p in stored.named_parameters():       # a split one: none until gathered
                set_param(self._whole, n, p if self.shardings[n].trivial else None)
            if by_block:
                self._whole.blocks = _BlockByBlock(self._whole.blocks, self, stored)
        self._put(stored, self.split_outside if by_block else self.split)
        return self._whole

    def gathered_bytes(self, stored: Transformer, by_block: bool = False) -> int:
        """The most bytes of gathered copies alive at once in a forward on
        ``gather(stored, by_block)``: every split parameter's whole size, or
        with ``by_block`` those outside the layers and the largest layer's."""
        def whole(names) -> int:
            total = 0
            for n in names:
                sh, p = self.shardings[n], stored.get_parameter(n)
                sizes = axis_sizes(sh.mesh)
                split = math.prod(sizes[a] for e in sh.spec for a in sh._live(e))
                total += p.numel() * p.element_size() * split
            return total

        if not by_block:
            return whole(self.split)
        return whole(self.split_outside) + max(map(whole, self.split_by_block.values()),
                                               default=0)

    def release(self) -> None:
        """Drop the gathered copies (the shared parameters stay)."""
        if self._whole is not None:
            self._drop(self.split)

    @contextlib.contextmanager
    def gathered(self, stored: Transformer, by_block: bool = False):
        """``with whole.gathered(stored) as module:`` — gathered for the
        block, released after it."""
        module = self.gather(stored, by_block)
        try:
            yield module
        finally:
            self.release()
