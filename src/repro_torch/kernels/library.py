"""The kernels as PyTorch operators.

Each CUDA entry of the port is a ``torch.library`` operator named
``repro_torch::<name>``: its CUDA kernel is the wrapper's ``ctypes``
launch, its fake implementation gives the output's shape, dtype and
device without touching data, and its FLOP formula (for
``torch.utils.flop_counter.FlopCounterMode``) counts the operations that
``chip_smoke.py``'s bound for the kernel counts when every point is live
and every slot valid: a trace on shape-only tensors has no data to
count the live ones from. So a fake trace (``FakeTensorMode``) of a path
that reaches a kernel never hands a null pointer to the card, and
counts its work.

Only the card's tensors reach an operator (:func:`on_card`): the
wrappers run their plain versions on CPU tensors themselves. One
exception: a build of PyTorch without CUDA cannot run every operator on
fake ``cuda`` tensors (its composite operators ask for a CUDA device
guard), so a fake trace there runs on fake CPU tensors inside
:func:`card_stand_in`, which makes them stand for the named card's: the
wrappers call their operators (the fake implementations run) and plans
are made for that card (``msda.plan.platform_of``). Registering an
operator builds nothing; the kernels still build at their first
launch."""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, NamedTuple, Optional

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "repro_torch"


class Card(NamedTuple):
    """What a plan and a dry run read of a card."""
    name: str                  # torch.cuda.get_device_name
    l2_bytes: int              # L2_cache_size
    memory_bytes: int          # total_memory
    sm_count: int              # multi_processor_count


#: The card a trace on a build without CUDA stands for (the port's
#: target: an H100 SXM as ``torch.cuda.get_device_properties`` reports
#: it: 50 MiB of L2, 85,017,493,504 B (79.18 GiB) of memory, 132 SMs).
H100_SXM = Card("NVIDIA H100 80GB HBM3", 50 * 2 ** 20, 85_017_493_504, 132)

_STAND_IN: contextvars.ContextVar = contextvars.ContextVar(
    "card_stand_in", default=None)


@contextlib.contextmanager
def card_stand_in(card: Card = H100_SXM):
    """Inside a fake trace, fake CPU tensors stand for ``card``'s."""
    token = _STAND_IN.set(card)
    try:
        yield card
    finally:
        _STAND_IN.reset(token)


def stood_in_card() -> Optional[Card]:
    """The card fake CPU tensors stand for, inside a fake trace."""
    from repro_torch.bridge import fake_mode_active
    card = _STAND_IN.get()
    return card if card is not None and fake_mode_active() else None


def on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper given ``t`` runs its kernel (its operator) rather
    than its plain version: a CUDA tensor, or a fake CPU tensor standing
    for the card's."""
    return t.device.type == "cuda" or (t.device.type == "cpu"
                                       and stood_in_card() is not None)


#: the operators' library (kept alive for the process)
_LIB = torch.library.Library(NAMESPACE, "DEF")


def kernel_op(name: str, *, fake: Callable, flops: Callable) -> Callable:
    """Decorator: ``fn`` (a kernel's launch, annotated with the types
    ``torch.library.infer_schema`` reads) becomes the CUDA kernel of the
    operator ``repro_torch::<name>``, ``fake`` its fake implementation and
    ``flops(*input_shapes, out_shape=...)`` its FLOP formula; returns the
    operator. The operator is defined through ``torch.library.Library``,
    not ``torch.library.custom_op``: the latter's Python dispatch costs
    about 19 µs a call against 1.7 µs (``torch.library`` on the CPU,
    measured for this choice), and the kernels need neither its autograd
    wrapper nor its schema checks (K2's gradient is an
    ``autograd.Function`` calling the operators)."""
    def wrap(fn: Callable):
        _LIB.define(name + torch.library.infer_schema(fn, mutates_args=()))
        _LIB.impl(name, fn, "CUDA")
        torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
        packet = getattr(getattr(torch.ops, NAMESPACE), name)
        register_flop_formula(packet)(flops)
        return packet.default
    return wrap


def numel(shape) -> int:
    return math.prod(shape)


def no_tensor(device: torch.device) -> torch.Tensor:
    """The placeholder an operator returns for an output it does not
    compute (an operator's outputs are tensors, never None)."""
    return torch.empty(0, device=device)
