"""MSCCL++ channels of the port: the protocols, plain rank-stacked models
of every channel of the reference, and the LL packet layout.

Port of ``repro/core/channels.py``. On the card a channel is no object:
every rank of an axis is a block of one kernel launch, a put is a write
into the peer's slot, and the device side lives in ``csrc/``
(``primitives.cuh``: ``put``/``signal``/``wait`` for HB,
``put_ll``/``read_ll`` for LL; ``channels.cuh``: ``PortChannel`` and
``FusedReduceChannel``). This module keeps what the CPU can run and
test: the plain models that the kernels' plain versions are written in,
and the LL layout (:func:`pack_ll`/:func:`unpack_ll`) that
``primitives.cuh:LLPacket`` stores.

Every model works on rank-stacked tensors: ``x[r]`` is rank ``r``'s
buffer, and a channel holds every rank's end at once (rank ``r`` talks
to ``peer[r]``). Flags are one int32 word a receiver (``(n,)``), or one
a (receiver, sender) pair for the fused channel (``(n, n)``); a signal
writes the launch's epoch into the peer's word, and a wait raises where
its own word does not hold the epoch (the reference spins until it
does, so a signal that is missing shows on the CPU as an error).

* ``MemoryChannel`` — the threads of the block copy (HB), or write LL
  packets: 4 data bytes and a 4-byte flag that travel in ONE 8-byte
  store, so a receiver that reads the expected flag reads the data of
  the same store — no separate signal message (paper §4.2.2). The TPU
  reference imitates this with a second flag descriptor per put; the
  paper's own layout is possible here.
* ``PortChannel`` — the same surface; on the card its put is a bulk
  copy of the SM's Tensor Memory Accelerator (``cp.async.bulk``): one
  elected thread stages a tile in shared memory and writes it to the
  peer's slot while the block's other threads stay free, and ``flush``
  waits for the copies (``cp.async.bulk.wait_group``). The paper's
  PortChannel moves data on the DMA engines through a CPU proxy and a
  request FIFO; the reference has neither (TPU cores enqueue their own
  DMAs) and neither has the port: an SM issues its own bulk copies.
* ``FusedReduceChannel`` (``SwitchChannel``) — the paper's switch
  channel reduces in the NVSwitch (NVLS ``multimem``). ``multimem``
  needs a multicast object over NVSwitch across GPUs, and the ranks of
  one card have none, so, as the reference does over ICI, peers push
  their chunks into per-sender slots and the receiver reduces them on
  arrival. API-compatible (``broadcast``/``recv``/``reduce``), the
  switch's arithmetic honestly absent.

No path of the port calls ``PortChannel`` or ``FusedReduceChannel``,
as no path of the reference does; ``kernels/channels.py`` holds their
device side against these models.
"""
from __future__ import annotations

import enum
import math
from typing import Optional

import torch

__all__ = ["Protocol", "Channel", "MemoryChannel", "PortChannel",
           "FusedReduceChannel", "SwitchChannel", "pack_ll", "unpack_ll"]


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


def _check_flags(flags: torch.Tensor, want: torch.Tensor, epoch: int,
                 what: str) -> None:
    """Raise unless every word of ``flags`` at ``want`` holds ``epoch``."""
    missing = flags[want] != epoch
    if bool(missing.any()):
        raise RuntimeError(
            f"{int(missing.sum())} {what} flag(s) do not hold epoch {epoch}: "
            f"a signal is missing (the card would spin until it came)")


class Channel:
    """Every rank's channel to one peer: rank ``r`` talks to ``peer[r]``
    (an ``(n,)`` index tensor). The paper's primitive surface (Fig. 6):
    ``put``/``put_with_signal``/``signal``/``wait``/``flush``."""

    def __init__(self, peer: torch.Tensor):
        self.peer = peer
        self.me = torch.arange(peer.shape[0], device=peer.device)

    def put(self, src: torch.Tensor, dst: torch.Tensor,
            slot: torch.Tensor) -> None:
        """``dst[peer[r], slot[r]] = src[r]`` for every rank ``r``."""
        dst[self.peer, slot] = src

    def put_with_signal(self, src: torch.Tensor, dst: torch.Tensor,
                        slot: torch.Tensor) -> None:
        """``put``: as in the reference, the delivery is its own signal
        (the receiver waits for the data, not for a separate message)."""
        self.put(src, dst, slot)

    def signal(self, flags: torch.Tensor, epoch: int) -> None:
        """Write ``epoch`` into ``peer[r]``'s flag word, for every ``r``
        (``flags``: ``(n,)``, one word a receiver)."""
        flags[self.peer] = epoch

    def wait(self, flags: torch.Tensor, epoch: int) -> None:
        """Every rank's wait for its own flag word to hold ``epoch``;
        raises where it does not."""
        _check_flags(flags, self.me, epoch, "channel")

    def flush(self) -> None:
        """Source-side completion before the signal and before ``src``
        is reused; a plain put has completed when it returns."""


class MemoryChannel(Channel):
    """The thread-copy channel: ``put`` (HB) and ``put_ll`` write rank
    ``r``'s ``src[r]`` into slot ``slot[r]`` of ``peer[r]``'s buffer, as
    one remote write per rank of the reference; ``read_ll`` is the
    receive side of LL."""

    def __init__(self, peer: torch.Tensor, protocol: Protocol = Protocol.HB):
        super().__init__(peer)
        self.protocol = protocol

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


class PortChannel(Channel):
    """The bulk-copy channel for large device-memory buffers: the same
    surface as :class:`Channel`. On the card (``csrc/channels.cuh``) a
    put is a TMA bulk copy issued by one thread, and ``flush`` is
    mandatory before the signal and before ``src`` is reused, exactly as
    in the paper."""


class FusedReduceChannel:
    """The reference's adaptation of the paper's ``SwitchChannel``:
    reduce/broadcast over the ``n`` ranks of an axis as push +
    reduce-on-arrival. Slots are ``(n, n, ...)``: ``slots[r, s]`` is
    rank ``r``'s slot for sender ``s``; flags ``(n, n)`` alike.

    broadcast(): every rank pushes its chunk to every peer's slot.
    reduce():    every rank waits for its n - 1 arrivals and adds them
                 to its own chunk, in the reference's order."""

    def __init__(self, n: int, device=None):
        self.n = n
        self.me = torch.arange(n, device=device)

    def broadcast(self, src: torch.Tensor, slots: torch.Tensor,
                  flags: Optional[torch.Tensor] = None,
                  epoch: Optional[int] = None) -> None:
        """``slots[peer, r] = src[r]`` for every rank ``r`` and every
        peer ``(r + i) % n``, ``i`` in ``1 .. n-1``; with ``flags``, each
        delivery signals ``flags[peer, r] = epoch``."""
        for i in range(1, self.n):
            peer = (self.me + i) % self.n
            slots[peer, self.me] = src
            if flags is not None:
                flags[peer, self.me] = epoch

    def recv(self, flags: torch.Tensor, epoch: int,
             frm: torch.Tensor) -> None:
        """Every rank's wait for the chunk of sender ``frm[r]``; raises
        where its flag does not hold ``epoch``."""
        _check_flags(flags[self.me, frm], slice(None), epoch, "slot")

    def reduce(self, local: torch.Tensor, slots: torch.Tensor,
               flags: Optional[torch.Tensor] = None,
               epoch: Optional[int] = None) -> torch.Tensor:
        """``local[r] + slots[r, (r+1)%n] + slots[r, (r+2)%n] + ...`` for
        every rank ``r``: the reference's ``fori_loop(1, n)`` left fold,
        rounded to the element type after every add (as
        ``primitives.cuh:Elem<T>::add``). With ``flags``, first waits for
        the ``n - 1`` arrivals."""
        if flags is not None:
            for i in range(1, self.n):
                self.recv(flags, epoch, (self.me + i) % self.n)
        acc = local.clone()
        for i in range(1, self.n):
            acc = acc + slots[self.me, (self.me + i) % self.n]
        return acc


# the paper's name for it
SwitchChannel = FusedReduceChannel
