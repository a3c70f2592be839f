"""Token-trie prefix index over KV-cache slot snapshots (a copy of the
reference's ``repro.serve.prefix_cache``; numpy only).

The serving north star (millions of requests sharing a handful of
system prompts) makes the prompt prefix the single most redundant
computation in the stack: every request re-prefills the same tokens
into its KV slot. This module is the reuse layer above the fused
prefill path — a radix trie keyed by token sequences whose nodes carry
the KV-cache bytes those tokens produced, so :class:`~repro_torch.serve
.scheduler.Scheduler` admission can seed a fresh slot with the longest
cached prefix and skip straight to the divergent suffix. The scheduler
hands the trie numpy arrays: a bf16 leaf travels as a ``uint16`` view
of its bits (numpy has no bf16) and goes back with
``.view(torch.bfloat16)``, bit for bit.

Design (copy-on-write by construction):

* **Radix nodes.** Each node owns a run of *delta* tokens and, per
  cache-leaf kind (``k``, ``v``, and the int8 scales), the matching
  token-axis slice of a slot snapshot — shape ``(groups, n_kv,
  len(tokens), last)`` with the token axis fixed at 2. A shared prefix
  is stored once; divergent suffixes split the node (slicing is cheap,
  numpy views are materialized to keep nodes self-owned).
* **COW sharing.** The trie NEVER aliases live engine cache memory:
  :meth:`insert` deep-copies the snapshot in, :meth:`acquire` hands a
  fresh concatenated copy out. Readers therefore cannot observe each
  other's writes — the differential harness's bit-identity guarantee
  does not depend on eviction timing.
* **Refcounted eviction.** :meth:`acquire`/:meth:`insert` pin the
  deepest node they touch; :meth:`release` unpins. Eviction (over
  ``capacity_tokens``) removes least-recently-used *unpinned leaves*
  only — a pinned node is never a candidate, and an interior node
  cannot be removed before all its children, so a pinned path is
  unreachable by eviction. Time is a logical clock (one tick per
  operation), so behaviour is fully deterministic under a seed.

Exact-fallback contract: a miss (or a post-eviction partial hit) costs
only the un-matched prefill tokens — the scheduler's cold path is the
ordinary prefill, so cached and uncached streams are bit-identical.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["PrefixCache"]

_TOKEN_AXIS = 2   # (groups, n_kv, tokens, last) — slot snapshots, see above


class _Node:
    __slots__ = ("tokens", "segs", "children", "parent", "pins", "last_use")

    def __init__(self, tokens: tuple, segs: Dict[str, np.ndarray],
                 parent: Optional["_Node"]):
        self.tokens = tokens
        self.segs = segs                  # kind -> (g, n_kv, len(tokens), *)
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.pins = 0
        self.last_use = 0


class _Handle:
    """An acquired/inserted prefix lease; pass to :meth:`PrefixCache
    .release` exactly once (double release is a guarded no-op)."""
    __slots__ = ("node", "released")

    def __init__(self, node: _Node):
        self.node = node
        self.released = False


def _slice_segs(segs: Dict[str, np.ndarray], lo: int,
                hi: Optional[int]) -> Dict[str, np.ndarray]:
    # unconditional copy: ascontiguousarray on an already-contiguous
    # full slice returns the input VIEW, which would alias caller memory
    return {k: np.array(v[:, :, lo:hi], order="C", copy=True)
            for k, v in segs.items()}


class PrefixCache:
    """See the module docstring. ``capacity_tokens`` bounds the total
    token count stored across all nodes (root excluded, it holds none);
    ``None`` = unbounded."""

    def __init__(self, capacity_tokens: Optional[int] = None):
        if capacity_tokens is not None and capacity_tokens < 1:
            raise ValueError(f"capacity_tokens must be >= 1 or None, "
                             f"got {capacity_tokens}")
        self.capacity_tokens = capacity_tokens
        self.root = _Node((), {}, None)
        self._tokens = 0
        self._clock = 0
        self.counters = {"hits": 0, "misses": 0, "inserts": 0,
                         "evictions": 0, "splits": 0,
                         "tokens_reused": 0}

    # -- internal ----------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _walk(self, prompt: Sequence[int]):
        """Longest-prefix walk. Returns (path, matched) where ``path``
        is the list of (node, n_used) pairs below the root that
        contribute ``n_used > 0`` tokens each and ``matched`` is the
        total longest-common-prefix length."""
        path: List[Tuple[_Node, int]] = []
        node, i = self.root, 0
        while i < len(prompt):
            child = node.children.get(int(prompt[i]))
            if child is None:
                break
            k = 0
            while (k < len(child.tokens) and i + k < len(prompt)
                   and child.tokens[k] == int(prompt[i + k])):
                k += 1
            path.append((child, k))
            i += k
            if k < len(child.tokens):
                break
            node = child
        return path, i

    def _split(self, node: _Node, k: int) -> _Node:
        """Split ``node`` after its first ``k`` delta tokens; ``node``
        keeps the top part (object identity — existing pins stay on the
        shared-prefix side), a new child takes the tail. Returns
        ``node``."""
        assert 0 < k < len(node.tokens)
        tail = _Node(node.tokens[k:], _slice_segs(node.segs, k, None), node)
        tail.children = node.children
        for c in tail.children.values():
            c.parent = tail
        tail.last_use = node.last_use
        node.tokens = node.tokens[:k]
        node.segs = _slice_segs(node.segs, 0, k)
        node.children = {int(tail.tokens[0]): tail}
        self.counters["splits"] += 1
        return node

    def _evict(self) -> None:
        if self.capacity_tokens is None:
            return
        while self._tokens > self.capacity_tokens:
            victim = None
            stack = [self.root]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if (n is not self.root and not n.children and n.pins == 0
                        and (victim is None or n.last_use < victim.last_use)):
                    victim = n
            if victim is None:      # everything left is pinned
                return
            del victim.parent.children[int(victim.tokens[0])]
            self._tokens -= len(victim.tokens)
            self.counters["evictions"] += 1

    # -- public API --------------------------------------------------------
    def match(self, prompt: Sequence[int]) -> int:
        """Longest cached prefix length of ``prompt`` (pure lookup — no
        pin, no LRU touch)."""
        _, matched = self._walk(prompt)
        return matched

    def acquire(self, prompt: Sequence[int]):
        """Lease the longest cached prefix of ``prompt``.

        Returns ``(L, segs, handle)``: the matched length, a dict of
        freshly-copied ``(groups, n_kv, L, last)`` arrays per cache
        kind (``None`` when ``L == 0``), and the lease to
        :meth:`release` (``None`` on a total miss). The deepest touched
        node is pinned until release, so eviction cannot reclaim the
        shared prefix while this request decodes on top of it."""
        now = self._tick()
        path, matched = self._walk(prompt)
        if matched == 0:
            self.counters["misses"] += 1
            return 0, None, None
        self.counters["hits"] += 1
        self.counters["tokens_reused"] += matched
        parts: List[Dict[str, np.ndarray]] = []
        for node, used in path:
            node.last_use = now
            parts.append(node.segs if used == len(node.tokens)
                         else _slice_segs(node.segs, 0, used))
        kinds = parts[0].keys()
        segs = {k: np.ascontiguousarray(
            np.concatenate([p[k] for p in parts], axis=_TOKEN_AXIS))
            for k in kinds}
        deepest = path[-1][0]
        deepest.pins += 1
        return matched, segs, _Handle(deepest)

    def insert(self, prompt: Sequence[int], segs: Dict[str, np.ndarray]):
        """Index ``prompt`` with its slot snapshot (one ``(groups,
        n_kv, len(prompt), last)`` array per cache kind). Shared
        prefixes dedupe against existing nodes (splitting where the new
        prompt diverges mid-node); only the novel suffix stores new
        bytes. The terminal node comes back pinned (release when the
        request leaves its slot). Runs eviction afterwards."""
        prompt = [int(t) for t in prompt]
        for k, v in segs.items():
            if v.shape[_TOKEN_AXIS] != len(prompt):
                raise ValueError(
                    f"segment {k!r} has {v.shape[_TOKEN_AXIS]} tokens on "
                    f"axis {_TOKEN_AXIS}, prompt has {len(prompt)}")
        now = self._tick()
        self.counters["inserts"] += 1
        path, matched = self._walk(prompt)
        node = self.root
        if path:
            tail_node, used = path[-1]
            if used < len(tail_node.tokens):
                node = self._split(tail_node, used)
            else:
                node = tail_node
            for n, _ in path:
                n.last_use = now
        if matched < len(prompt):
            child = _Node(tuple(prompt[matched:]),
                          _slice_segs(segs, matched, None), node)
            child.last_use = now
            node.children[prompt[matched]] = child
            self._tokens += len(child.tokens)
            node = child
        handle = None
        if node is not self.root:
            node.pins += 1
            handle = _Handle(node)
        self._evict()
        return handle

    def release(self, handle) -> None:
        """Unpin a lease from :meth:`acquire`/:meth:`insert`. ``None``
        and double releases are no-ops; pins never go negative."""
        if handle is None or handle.released:
            return
        handle.released = True
        if handle.node.pins > 0:
            handle.node.pins -= 1
        # a release can unwedge a pin-blocked eviction pass
        self._evict()

    # -- introspection -----------------------------------------------------
    def stats(self) -> dict:
        nodes = pinned = 0
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            nodes += 1
            pinned += int(n.pins > 0)
        hits = self.counters["hits"]
        total = hits + self.counters["misses"]
        return dict(self.counters, nodes=nodes, tokens=self._tokens,
                    pinned=pinned,
                    hit_rate=(hits / total) if total else 0.0)

    def check(self) -> None:
        """Structural invariants (the property tests call this after
        every operation): token accounting exact, pins non-negative,
        child links consistent, radix compression holds (no empty
        nodes)."""
        total = 0
        stack = [(self.root, True)]
        while stack:
            n, is_root = stack.pop()
            assert n.pins >= 0, "negative pin count"
            if not is_root:
                assert len(n.tokens) > 0, "empty non-root node"
                total += len(n.tokens)
                for v in n.segs.values():
                    assert v.shape[_TOKEN_AXIS] == len(n.tokens)
            for first, c in n.children.items():
                assert c.parent is n, "broken parent link"
                assert int(c.tokens[0]) == first, "mis-keyed child"
                stack.append((c, False))
        assert total == self._tokens, (
            f"token accounting drift: counted {total}, "
            f"tracked {self._tokens}")
        if (self.capacity_tokens is not None
                and self._tokens > self.capacity_tokens):
            # over capacity is legal only when eviction is wedged on
            # pins: every remaining leaf must be pinned
            stack = list(self.root.children.values())
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if not n.children:
                    assert n.pins > 0, (
                        "over capacity with an evictable (unpinned) leaf")
