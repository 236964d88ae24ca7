"""S networks of one architecture as one: stacked parameters, vmapped calls.

A seed population (``train/population.py``) trains S independent learners
as one program. Their networks share an architecture, so each parameter is
held once as a tensor with a leading member axis ``(S, ...)``, and a network
method runs for all members in one call through ``torch.func.vmap`` over
``torch.func.functional_call`` of the ordinary module: one set of batched
aten calls whatever S is, where a loop over S modules would issue S sets.
The JAX package gets the same from ``jax.vmap`` over its flax ``apply``.

Inside the function handed to :func:`vmap_members`, each :class:`Stacked`
argument arrives as a :class:`Member`: the module's methods bound to one
member's parameters, so the learners' own loss functions run unchanged on
it. Members share no parameter, so the gradient of the SUM of the members'
losses gives each member's slice of every parameter its own gradient.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Sequence

import torch
from torch import nn
from torch.func import functional_call, vmap

from usv_tpu_torch.timing import vmap_counter


class _Call(nn.Module):
    """``forward(name, *args)`` calls the wrapped module's method ``name``
    (``functional_call`` only calls ``forward``)."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.m = module

    def forward(self, name, *args, **kwargs):
        return getattr(self.m, name)(*args, **kwargs)


class Stacked:
    """The parameters of S modules of one architecture, stacked member-major.

    ``params`` is a list of leaf tensors ``(S, *shape)``, one per parameter of
    the module in ``named_parameters`` order: the list an optimizer takes.
    The template module's buffers (the actor's action bounds) are the same
    for every member and are used unstacked."""

    def __init__(self, template: nn.Module, params: List[torch.Tensor]):
        self.names = [name for name, _ in template.named_parameters()]
        self.params = params
        self._buffers = {f"m.{name}": b for name, b in template.named_buffers()}
        self._call = _Call(copy.deepcopy(template).to("meta"))
        self._template = template

    @classmethod
    def from_modules(cls, modules: Sequence[nn.Module], requires_grad: bool = True) -> "Stacked":
        """The members ``modules`` (their parameters copied)."""
        names = [name for name, _ in modules[0].named_parameters()]
        params = [torch.stack([dict(m.named_parameters())[name].detach() for m in modules])
                  .requires_grad_(requires_grad) for name in names]
        return cls(modules[0], params)

    def member(self, i: int) -> Dict[str, torch.Tensor]:
        """Member ``i``'s parameters: a ``state_dict`` of detached copies that
        an ordinary module of the architecture loads."""
        return {name: p[i].detach().clone() for name, p in zip(self.names, self.params)}

    def take(self, keep: torch.Tensor) -> "Stacked":
        """The members ``keep`` (an index tensor), as new leaf tensors."""
        return Stacked(self._template, [p.detach().index_select(0, keep).requires_grad_(p.requires_grad)
                                        for p in self.params])

    def copy(self, requires_grad: bool = False) -> "Stacked":
        """Detached copies of every member's parameters (a target network)."""
        return Stacked(self._template, [p.detach().clone().requires_grad_(requires_grad)
                                        for p in self.params])


class Member:
    """One member inside :func:`vmap_members`: ``member(*args)`` is the
    module's ``forward`` and ``member.<method>(*args)`` its method, on this
    member's parameters."""

    def __init__(self, stacked: Stacked, params: Sequence[torch.Tensor]):
        self._stacked = stacked
        self._state = dict(zip((f"m.{n}" for n in stacked.names), params), **stacked._buffers)

    def _run(self, name, *args, **kwargs):
        return functional_call(self._stacked._call, self._state, (name, *args), kwargs)

    def __call__(self, *args, **kwargs):
        return self._run("forward", *args, **kwargs)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *args, **kwargs: self._run(name, *args, **kwargs)


def vmap_members(fn: Callable, stacks: Sequence[Stacked], *args):
    """``fn(*members, *member_args)`` for every member at once.

    ``stacks`` are :class:`Stacked` networks of S members each; every tensor
    in ``args`` (nested in tuples, lists or dicts as ``vmap`` allows) has the
    member axis first. ``fn`` sees one :class:`Member` per stack and one
    member's slice of each argument; its outputs gain the member axis.
    Non-tensor constants belong in ``fn``'s closure. Each call adds one to
    ``timing.vmap_counter`` (to a capture's tally while a CUDA graph
    captures)."""
    vmap_counter.launched()

    def inner(plists, *member_args):
        return fn(*(Member(s, p) for s, p in zip(stacks, plists)), *member_args)

    return vmap(inner)([s.params for s in stacks], *args)
