"""MSCCL++ channels of the port: the protocols, a plain rank-stacked
model of ``MemoryChannel``, and the LL packet layout.

Port of ``repro/core/channels.py``. On the card a channel is no object:
every rank of an axis is a block of one kernel launch, a put is a store
into the peer's slot, and the device side lives in
``csrc/primitives.cuh`` (``put``/``signal``/``wait`` for HB,
``put_ll``/``read_ll`` for LL). This module keeps what the CPU can run
and test: the plain model that the kernels' plain versions are written
in, and the LL layout (:func:`pack_ll`/:func:`unpack_ll`) that
``primitives.cuh:LLPacket`` stores.

LL (paper §4.2.2): a packet is 4 data bytes and a 4-byte flag that
travel in ONE 8-byte store, so a receiver that reads the expected flag
reads the data of the same store — no separate signal message. The TPU
reference imitates this with a second flag descriptor per put; the
paper's own layout is possible here. ``PortChannel`` and
``FusedReduceChannel``/``SwitchChannel`` have no caller on the port's
paths yet (ROADMAP.md §1 item 5).
"""
from __future__ import annotations

import enum
import math

import torch

__all__ = ["Protocol", "MemoryChannel", "pack_ll", "unpack_ll"]


class Protocol(enum.Enum):
    HB = "HB"  # high-bandwidth: bulk copy, then one flag per delivery
    LL = "LL"  # low-latency: data + flag per 8-byte packet, receiver polls


def _pack(flat: torch.Tensor, epoch: int) -> torch.Tensor:
    """(B, count) payloads -> (B, words, 2) int32 {data, flag} packets."""
    if flat.element_size() == 2:
        if flat.shape[1] % 2:           # the last word's high half is 0
            flat = torch.cat([flat, flat.new_zeros(flat.shape[0], 1)], 1)
    elif flat.element_size() != 4:
        raise ValueError(f"LL packets carry 2- or 4-byte elements, got "
                         f"{flat.dtype}")
    words = flat.contiguous().view(torch.int32)
    return torch.stack([words, torch.full_like(words, epoch)], dim=-1)


def _unpack(packets: torch.Tensor, epoch: int, dtype: torch.dtype,
            count: int) -> torch.Tensor:
    """(B, words, 2) packets -> (B, count) payloads of ``dtype``, after
    checking that every flag is ``epoch``."""
    stale = packets[..., 1] != epoch
    if bool(stale.any()):
        raise RuntimeError(
            f"{int(stale.sum())} LL packet(s) carry a flag other than epoch "
            f"{epoch}: stale or not yet delivered")
    words = packets[..., 0].contiguous()
    return words.view(dtype)[:, :count]


def pack_ll(payload: torch.Tensor, epoch: int) -> torch.Tensor:
    """One message as LL packets: ``(words, 2)`` int32, each
    ``[4 data bytes, epoch]``. A 4-byte element is one word; 2-byte
    elements (bf16, f16) go two to a word, the last word zero-padded
    when the count is odd (little-endian: element 2w in the low half)."""
    return _pack(payload.reshape(1, -1), epoch)[0]


def unpack_ll(packets: torch.Tensor, epoch: int, *, dtype: torch.dtype,
              shape) -> torch.Tensor:
    """The payload of ``packets`` as ``dtype`` in ``shape``; raises if any
    flag differs from ``epoch`` (a stale or missing packet)."""
    return _unpack(packets[None], epoch, dtype,
                   math.prod(shape))[0].reshape(shape)


class MemoryChannel:
    """Every rank's channel to one peer, on rank-stacked tensors: rank
    ``r`` talks to ``peer[r]``. ``put`` and ``put_ll`` write rank ``r``'s
    ``src[r]`` into slot ``slot[r]`` of ``peer[r]``'s buffer, as one
    remote write per rank of the reference; ``read_ll`` is the receive
    side of LL."""

    def __init__(self, peer: torch.Tensor, protocol: Protocol = Protocol.HB):
        self.peer = peer
        self.protocol = protocol
        self.me = torch.arange(peer.shape[0], device=peer.device)

    def put(self, src: torch.Tensor, dst: torch.Tensor,
            slot: torch.Tensor) -> None:
        """``dst[peer[r], slot[r]] = src[r]`` for every rank ``r``."""
        dst[self.peer, slot] = src

    def put_ll(self, src: torch.Tensor, dst: torch.Tensor,
               slot: torch.Tensor, epoch: int) -> None:
        """``put`` as LL packets: ``dst`` is ``(n, slots, words, 2)``."""
        if self.protocol is not Protocol.LL:
            raise ValueError("put_ll requires an LL-protocol channel")
        dst[self.peer, slot] = _pack(src.reshape(src.shape[0], -1), epoch)

    def read_ll(self, packets: torch.Tensor, slot: torch.Tensor, epoch: int,
                *, dtype: torch.dtype, shape) -> torch.Tensor:
        """Rank ``r``'s payload in its own slot ``slot[r]``, checked
        against ``epoch`` (the reference polls the flag until it shows)."""
        got = _unpack(packets[self.me, slot], epoch, dtype, math.prod(shape))
        return got.reshape((self.me.shape[0],) + tuple(shape))
