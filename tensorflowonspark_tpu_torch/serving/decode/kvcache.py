"""Slot- and block-paged KV caches for continuous-batching decode.

Counterpart of ``tensorflowonspark_tpu/serving/decode/kvcache.py``: the
same host-side bookkeeping (free lists, block tables, refcounts, prefix
trie), with the K/V pools as torch tensors on the engine's device.  Two
tiers:

:class:`SlotKVCache` — vLLM-style paging simplified to one page per
session: two preallocated ``[slots, n_layers, n_heads, max_seq,
head_dim]`` arrays (keys cached rope-rotated) plus a per-slot length
cursor.  Admission/retirement are O(1) (pop/push a free slot) and the
fused ``models/transformer.decode_step`` always sees the same
``[slots, ...]`` arrays.

:class:`PagedKVCache` — full block paging with ref-counted prefix
sharing: the pool is ``[num_blocks, n_layers, n_heads, block_size,
head_dim]`` and each slot maps logical positions through a per-slot
block-table row (``models/transformer.decode_step_paged`` gathers
through it).  Blocks carry refcounts, so admission can map a new
request's matched prompt-prefix blocks from the :class:`PrefixTrie`
(bumping refcounts) instead of re-prefilling them — only the unmatched
tail is prefilled, and tail writes always land in session-private
blocks because trie matches are whole-block (copy-on-write by block
alignment, never in place).  Retired sessions decref; blocks a trie
path still references stay resident for future hits and are reclaimed
LRU-leaf-first only when allocation would otherwise fail.

Physical block 0 is a reserved SENTINEL: free slots' table rows point
at it, so their numerically-inert writes (and the padded rows of a
bucketed ``prefill_extend``) land in a block no live session ever
attends to — the paged analogue of SlotKVCache's stale-own-page
contract.  Capacity is validated so live sessions can never be starved:
``num_blocks - 1 >= slots * blocks_per_slot`` and everything above the
sentinel that is not session-referenced is trie-reclaimable.

Pools start at ZERO, never ``torch.empty``: masked positions still enter
``probs @ V`` at weight 0, and 0 * NaN from uninitialised memory would
poison live rows.
"""

from __future__ import annotations

import numpy as np
import torch

from tensorflowonspark_tpu_torch import resolve_device


class CacheOOM(RuntimeError):
    """Block allocation failed even after trie reclamation."""


class SlotKVCache:
    """Preallocated per-slot K/V pages + host-side cursor/free-list."""

    def __init__(self, cfg, slots, max_seq=None, dtype=None, device=None):
        device = resolve_device(device)  # None: the card, or raise
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError("need at least one slot")
        self.max_seq = int(max_seq or cfg.max_seq)
        self.dtype = dtype or cfg.compute_dtype
        shape = (self.slots, cfg.n_layers, cfg.n_heads, self.max_seq,
                 cfg.head_dim)
        self.k = torch.zeros(shape, dtype=self.dtype, device=device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=device)
        # host mirrors: the scheduler reads/writes these every iteration
        # without a device round-trip
        self.lengths = np.zeros((self.slots,), np.int32)
        self._free = list(range(self.slots - 1, -1, -1))  # pop() -> slot 0

    # -- slot lifecycle -----------------------------------------------------
    def alloc(self):
        """A free slot index, or None when the cache is full."""
        return self._free.pop() if self._free else None

    def retire(self, slot):
        """Return ``slot`` to the free list (cursor back to 0; the page
        itself is left stale — see the inertness contract above)."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        self.lengths[slot] = 0
        self._free.append(slot)

    def insert(self, slot, k, v, length):
        """Install a prefill result: ``k``/``v``
        [n_layers, n_heads, T, head_dim] into ``slot``'s first T
        columns, cursor to ``length`` (<= T <= max_seq)."""
        t = k.shape[2]
        if t > self.max_seq:
            raise ValueError(f"prefill length {t} > max_seq {self.max_seq}")
        self.k[slot, :, :, :t] = k.to(self.k.device, self.dtype)
        self.v[slot, :, :, :t] = v.to(self.v.device, self.dtype)
        self.lengths[slot] = int(length)

    # -- introspection ------------------------------------------------------
    @property
    def occupancy(self):
        return self.slots - len(self._free)

    @property
    def free_slots(self):
        return len(self._free)


class _TrieNode:
    __slots__ = ("children", "block", "tick")

    def __init__(self, block, tick):
        self.children = {}      # block-token tuple -> _TrieNode
        self.block = int(block)
        self.tick = tick


class PrefixTrie:
    """Prompt-prefix index over resident KV blocks.

    Keys are whole blocks of prompt tokens (tuples of ``block_size``
    ints), so a match is always block-aligned — the property that lets
    a matching session map the physical blocks directly (the KV of a
    prompt position depends only on the tokens at and before it, and
    keys are cached post-rope, so identical prompt blocks at identical
    positions have identical cache content).  Each node holds ONE
    refcount on its physical block (taken at insert, dropped at evict);
    session references stack on top, so ``refcount == 1`` means
    "trie-only" — the reclaimable state.

    Host-side bookkeeping only; the trie never touches device arrays.
    """

    def __init__(self, block_size):
        self.block_size = int(block_size)
        self.root = {}          # block-token tuple -> _TrieNode
        self._tick = 0
        self.nodes = 0

    def _blocks_of(self, tokens, limit=None):
        bs = self.block_size
        n = len(tokens) // bs if limit is None else min(
            len(tokens) // bs, limit)
        return [tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])
                for i in range(n)]

    def match(self, tokens, limit=None):
        """Physical block ids of the longest resident whole-block
        prefix of ``tokens`` (at most ``limit`` blocks); touches the
        matched path's LRU ticks."""
        self._tick += 1
        out, children = [], self.root
        for key in self._blocks_of(tokens, limit):
            node = children.get(key)
            if node is None:
                break
            node.tick = self._tick
            out.append(node.block)
            children = node.children
        return out

    def insert(self, tokens, phys_blocks, incref):
        """Register ``tokens``' whole-block prefix as resident in
        ``phys_blocks`` (one id per block).  Existing nodes keep their
        own (content-identical) blocks; each NEWLY created node calls
        ``incref(block)`` to take the trie's reference."""
        self._tick += 1
        children = self.root
        for key, block in zip(self._blocks_of(tokens), phys_blocks):
            node = children.get(key)
            if node is None:
                node = _TrieNode(block, self._tick)
                children[key] = node
                self.nodes += 1
                incref(node.block)
            else:
                node.tick = self._tick
            children = node.children

    def reclaim(self, need, refcount, release):
        """Evict least-recently-matched leaf nodes whose blocks are
        trie-only (``refcount[block] == 1``) until ``need`` blocks were
        released or nothing else is evictable.  Returns the count
        released.  Evicting a leaf may expose its parent as the next
        candidate, so the scan loops to fixpoint."""
        freed = 0
        while freed < need:
            best = None  # (tick, parent_children, key, node)
            stack = [self.root]
            while stack:
                children = stack.pop()
                for key, node in children.items():
                    if node.children:
                        stack.append(node.children)
                    elif refcount[node.block] == 1 and (
                            best is None or node.tick < best[0]):
                        best = (node.tick, children, key, node)
            if best is None:
                return freed
            _, children, key, node = best
            del children[key]
            self.nodes -= 1
            release(node.block)
            freed += 1
        return freed


class PagedKVCache:
    """Block-paged K/V pool + per-slot block tables + prefix trie.

    Device side: ``k``/``v`` ``[num_blocks, n_layers, n_heads,
    block_size, head_dim]``.  Host side: ``block_tables`` [slots,
    blocks_per_slot] int32 (unused entries point at sentinel block 0),
    ``lengths`` [slots], ``refcount`` [num_blocks], a block free list
    and a slot free list.  ``models/transformer.decode_step_paged`` and
    ``prefill_extend`` consume the pool + tables directly.
    """

    def __init__(self, cfg, slots, block_size=None, num_blocks=None,
                 max_seq=None, dtype=None, prefix_sharing=True,
                 device=None):
        device = resolve_device(device)  # None: the card, or raise
        self.slots = int(slots)
        if self.slots < 1:
            raise ValueError("need at least one slot")
        self.max_seq = int(max_seq or cfg.max_seq)
        self.block_size = int(block_size or 16)
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.blocks_per_slot = -(-self.max_seq // self.block_size)
        min_blocks = 1 + self.slots * self.blocks_per_slot
        # default: 2x the live working set — the surplus is what lets
        # trie-retained prefixes of RETIRED sessions stay resident
        self.num_blocks = int(num_blocks or
                              1 + 2 * self.slots * self.blocks_per_slot)
        if self.num_blocks < min_blocks:
            raise ValueError(
                f"num_blocks {self.num_blocks} < sentinel + "
                f"slots*blocks_per_slot = {min_blocks}: live sessions "
                "could starve")
        self.dtype = dtype or cfg.compute_dtype
        shape = (self.num_blocks, cfg.n_layers, cfg.n_heads,
                 self.block_size, cfg.head_dim)
        self.k = torch.zeros(shape, dtype=self.dtype, device=device)
        self.v = torch.zeros(shape, dtype=self.dtype, device=device)
        self.block_tables = np.zeros((self.slots, self.blocks_per_slot),
                                     np.int32)
        self.lengths = np.zeros((self.slots,), np.int32)
        self.refcount = np.zeros((self.num_blocks,), np.int64)
        self.refcount[0] = 1            # sentinel: pinned forever
        self._nblocks = np.zeros((self.slots,), np.int32)
        self._free_blocks = list(range(self.num_blocks - 1, 0, -1))
        self._free = list(range(self.slots - 1, -1, -1))
        self.trie = PrefixTrie(self.block_size) if prefix_sharing else None

    # -- block accounting ---------------------------------------------------
    def _incref(self, block):
        self.refcount[block] += 1

    def _release(self, block):
        self.refcount[block] -= 1
        if self.refcount[block] < 0:
            raise AssertionError(f"block {block} refcount underflow")
        if self.refcount[block] == 0 and block != 0:
            self._free_blocks.append(block)

    def alloc_blocks(self, n):
        """``n`` fresh private blocks (refcount 1 each), reclaiming
        trie-only blocks LRU-first if the free list runs dry; raises
        :class:`CacheOOM` when live sessions hold everything."""
        if n > len(self._free_blocks) and self.trie is not None:
            self.trie.reclaim(n - len(self._free_blocks), self.refcount,
                              self._release)
        if n > len(self._free_blocks):
            raise CacheOOM(
                f"need {n} blocks, {len(self._free_blocks)} free "
                f"(pool {self.num_blocks}, in use {self.blocks_in_use})")
        out = [self._free_blocks.pop() for _ in range(n)]
        for b in out:
            self.refcount[b] += 1
        return out

    # -- slot lifecycle -----------------------------------------------------
    def alloc(self):
        """A free slot index, or None when all slots are occupied
        (blocks are allocated separately via :meth:`map_session`)."""
        return self._free.pop() if self._free else None

    def free_slot(self, slot):
        """Undo a bare :meth:`alloc` (admission rollback before any
        blocks were mapped)."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        self._free.append(slot)

    def map_session(self, slot, shared_blocks, own_blocks, length):
        """Install a session's block-table row: ``shared_blocks``
        (trie-matched, this call takes the session's refs) then
        ``own_blocks`` (already ref'd by :meth:`alloc_blocks`), cursor
        to ``length``."""
        blocks = list(shared_blocks) + list(own_blocks)
        if len(blocks) > self.blocks_per_slot:
            raise ValueError(
                f"{len(blocks)} blocks > blocks_per_slot "
                f"{self.blocks_per_slot}")
        for b in shared_blocks:
            self._incref(b)
        row = self.block_tables[slot]
        row[:] = 0
        row[:len(blocks)] = blocks
        self._nblocks[slot] = len(blocks)
        self.lengths[slot] = int(length)

    def ensure_capacity(self, slot, upto):
        """Grow ``slot``'s table so logical positions < ``upto`` are
        backed by real blocks (decode writes past the prompt)."""
        upto = min(int(upto), self.blocks_per_slot * self.block_size)
        need = -(-upto // self.block_size)
        have = int(self._nblocks[slot])
        if need <= have:
            return
        fresh = self.alloc_blocks(need - have)
        self.block_tables[slot, have:need] = fresh
        self._nblocks[slot] = need

    def retire(self, slot):
        """Free the slot and drop the session's block refs — shared
        blocks survive while the trie (or another session) still
        references them."""
        if slot in self._free:
            raise ValueError(f"slot {slot} is already free")
        for b in self.block_tables[slot, :self._nblocks[slot]]:
            self._release(int(b))
        self.block_tables[slot] = 0
        self._nblocks[slot] = 0
        self.lengths[slot] = 0
        self._free.append(slot)

    # -- prefix sharing -----------------------------------------------------
    def match_prefix(self, prompt):
        """(shared physical blocks, matched token count) for the
        longest resident whole-block prefix of ``prompt`` — capped one
        token short of the full prompt so admission always has a real
        tail to prefill (the tail's last position produces the
        first-token logits)."""
        if self.trie is None:
            return [], 0
        limit = (len(prompt) - 1) // self.block_size
        blocks = self.trie.match(prompt, limit=limit)
        return blocks, len(blocks) * self.block_size

    def register_prompt(self, slot, prompt):
        """Offer the session's whole-block prompt prefix to the trie
        (post-prefill, so the mapped blocks' content is final)."""
        if self.trie is None:
            return
        nb = len(prompt) // self.block_size
        self.trie.insert(prompt, [int(b) for b in
                                  self.block_tables[slot, :nb]],
                         self._incref)

    def drop_prefixes(self):
        """Forget every resident prefix: the trie's block references are
        released (blocks a live session maps stay until it retires).
        Called when the params change, since the resident K/V was
        computed with the old ones.  Returns the nodes dropped."""
        if self.trie is None:
            return 0
        dropped = 0
        stack = [self.trie.root]
        while stack:
            for node in stack.pop().values():
                self._release(node.block)
                dropped += 1
                stack.append(node.children)
        self.trie = PrefixTrie(self.block_size)
        return dropped

    # -- device writes ------------------------------------------------------
    def insert_tail(self, slot, k, v, start, length):
        """Install prefill K/V ``[n_layers, n_heads, T, head_dim]``
        into the slot's blocks covering positions ``[start, start +
        length)``.  ``start`` must be block-aligned (trie matches are
        whole-block); the padded remainder of the last block is
        session-private scratch that decode overwrites in order."""
        bs = self.block_size
        if start % bs:
            raise ValueError(f"tail start {start} not block-aligned ({bs})")
        t = int(length)
        if start + t > self.max_seq:
            raise ValueError(
                f"prefill end {start + t} > max_seq {self.max_seq}")
        first = start // bs
        nch = -(-t // bs)
        dev = self.k.device
        phys = torch.as_tensor(self.block_tables[slot, first:first + nch],
                               dtype=torch.long, device=dev)
        pad = nch * bs - t
        for pool, x in ((self.k, k), (self.v, v)):
            # stays on the device; the pad replicates the last real
            # column (edge mode), never zeros
            x = x.to(dev)[:, :, :t]
            if pad:
                x = torch.cat([x, x[:, :, t - 1:t].expand(-1, -1, pad, -1)],
                              dim=2)
            # [L, H, nch*bs, D] -> [nch, L, H, bs, D] (pool layout)
            ll, hh, _, dd = x.shape
            x = x.reshape(ll, hh, nch, bs, dd).permute(2, 0, 1, 3, 4)
            pool[phys] = x.to(self.dtype)

    # -- introspection ------------------------------------------------------
    @property
    def occupancy(self):
        return self.slots - len(self._free)

    @property
    def free_slots(self):
        return len(self._free)

    @property
    def blocks_in_use(self):
        """Blocks referenced by live sessions and/or the trie (the
        sentinel is excluded)."""
        return self.num_blocks - 1 - len(self._free_blocks)

    def leaked_blocks(self):
        """Refcount lint: block ids that are neither free, sentinel,
        session-referenced, nor trie-referenced — must always be
        empty."""
        refs = np.zeros((self.num_blocks,), np.int64)
        refs[0] = 1
        for slot in range(self.slots):
            for b in self.block_tables[slot, :self._nblocks[slot]]:
                refs[int(b)] += 1
        if self.trie is not None:
            stack = [self.trie.root]
            while stack:
                children = stack.pop()
                for node in children.values():
                    refs[node.block] += 1
                    stack.append(node.children)
        if not np.array_equal(refs, self.refcount):
            bad = np.nonzero(refs != self.refcount)[0]
            raise AssertionError(
                f"refcount drift at blocks {bad.tolist()}: "
                f"counted {refs[bad].tolist()}, "
                f"stored {self.refcount[bad].tolist()}")
        free = set(self._free_blocks)
        return [b for b in range(1, self.num_blocks)
                if self.refcount[b] == 0 and b not in free]
