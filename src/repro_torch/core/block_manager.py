"""Host-side paged block manager: free list, ref counts, block-level prefix
cache. Pure Python/numpy — drives the jitted device steps but never runs on
device.

Two prefix-cache policies (``CacheConfig.prefix_cache_policy``,
docs/CACHING.md):

``flat``
    The pre-radix behavior, byte-for-byte: a hash-chain map consulted for
    exact full-block matches, oldest-first eviction of unreferenced cached
    blocks. Kept for parity testing against the frozen legacy engine.

``radix``
    An SGLang-style radix tree over the same block-content hash chain.
    Every registered block is a tree node (one token-block per node, so
    "radix" collapses to a trie over block hashes — the natural unit here,
    since blocks are the allocation granularity); eviction is LRU over
    *leaves* only, so a hot shared prefix survives while its cold
    per-request suffixes are reclaimed first. The tree also carries
    *segments*: cached prefixes whose payload is **compressed** KV
    (``budget_blocks`` blocks condensing a longer span — the paper's
    compression applied to the cache itself), matched with transparent
    re-expansion accounting at hit time (``PrefixMatch.n_tokens`` covered
    vs ``n_entries`` occupied).

The flat-era surfaces (``hash_to_block`` / ``block_hash`` /
``cached_free``) stay live and authoritative in radix mode; the tree is an
index over them plus the segment maps.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple


class OutOfBlocks(Exception):
    pass


class _RadixNode:
    """One cached full block: ``key`` is its chain hash (which encodes the
    whole prefix up to and including this block), ``block`` the physical id.
    Children are keyed by their chain hash."""
    __slots__ = ("key", "block", "parent", "children")

    def __init__(self, key: int, block: int,
                 parent: Optional["_RadixNode"]):
        self.key = key
        self.block = block
        self.parent = parent
        self.children: Dict[int, "_RadixNode"] = {}


class _Segment:
    """A cached *compressed* prefix: ``blocks`` hold the condensed KV of the
    first ``n_tokens`` prompt tokens; ``key`` is the chain hash of the last
    full block the span covers. The cache itself holds no references —
    payload blocks park in ``cached_free`` when the last holder lets go, and
    they enter/leave it all-or-none (every holder holds the whole payload)."""
    __slots__ = ("key", "blocks", "n_tokens")

    def __init__(self, key: int, blocks: List[int], n_tokens: int):
        self.key = key
        self.blocks = blocks
        self.n_tokens = n_tokens


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of :meth:`BlockManager.lookup_prefix_ex`. ``n_tokens`` prompt
    tokens are covered by ``blocks`` holding ``n_entries`` KV cache entries;
    the two differ exactly when the match is a compressed segment
    (``compressed=True``), and the caller must account for the gap when
    deriving cache-write indices from token positions."""
    blocks: List[int]
    n_tokens: int
    n_entries: int
    chain: List[int]
    compressed: bool


PREFIX_CACHE_POLICIES = ("flat", "radix")


class BlockManager:
    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_cache: bool = True,
                 swap_space_blocks: int = 0,
                 prefix_cache_policy: str = "flat",
                 prefix_cache_watermark: float = 1.0):
        if prefix_cache_policy not in PREFIX_CACHE_POLICIES:
            raise ValueError(
                f"unknown prefix_cache_policy {prefix_cache_policy!r}; "
                f"expected one of {PREFIX_CACHE_POLICIES}")
        if not 0.0 <= prefix_cache_watermark <= 1.0:
            raise ValueError("prefix_cache_watermark must be in [0, 1] "
                             "(a fraction of the block pool)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_cache = enable_prefix_cache
        self.prefix_cache_policy = prefix_cache_policy
        self.prefix_cache_watermark = prefix_cache_watermark
        self._radix = prefix_cache_policy == "radix"
        self.free: List[int] = list(range(num_blocks - 1, -1, -1))
        self.ref: List[int] = [0] * num_blocks
        # prefix cache: content-hash -> block id; blocks with ref==0 but a
        # live hash are reusable-before-eviction (LRU order)
        self.hash_to_block: Dict[int, int] = {}
        self.block_hash: Dict[int, int] = {}
        self.cached_free: "OrderedDict[int, None]" = OrderedDict()
        # radix index over the hash maps (radix policy only)
        self.nodes: Dict[int, _RadixNode] = {}
        self.node_of_block: Dict[int, _RadixNode] = {}
        # compressed cached prefixes (radix policy only)
        self.segments: Dict[int, _Segment] = {}
        self.seg_of_block: Dict[int, _Segment] = {}
        self._seg_tokens = 0            # sum of segment n_tokens (O(1) stats)
        # cumulative cache telemetry (surfaced via cache_stats())
        self.n_lookups = 0
        self.n_hits = 0
        self.n_hit_tokens = 0
        self.n_segment_hits = 0
        self.n_evicted_blocks = 0
        self.n_invalidated_blocks = 0
        # host swap tier (docs/SCHEDULER.md "Preemption modes"): a CPU-side
        # pool of block slots a swap-out parks KV copies in. Swapped blocks
        # are per-request private copies — shared prefix blocks are
        # copy-on-swap, so the device ref counts simply drop by one and the
        # prefix cache keeps serving its other holders.
        self.swap_space_blocks = swap_space_blocks
        self.swap_free: List[int] = list(range(swap_space_blocks - 1, -1, -1))
        self.swapped: Dict[int, List[int]] = {}      # rid -> host blocks

    # ------------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self.free) + len(self.cached_free)

    def _deregister_block(self, blk: int) -> None:
        """Drop ``blk``'s hash registration (and radix node, if any)."""
        node = self.node_of_block.get(blk)
        if node is not None:
            self._drop_node(node)
            return
        h = self.block_hash.pop(blk, None)
        if h is not None:
            self.hash_to_block.pop(h, None)

    def _drop_node(self, node: _RadixNode) -> None:
        self.nodes.pop(node.key, None)
        self.node_of_block.pop(node.block, None)
        if self.block_hash.get(node.block) == node.key:
            del self.block_hash[node.block]
        self.hash_to_block.pop(node.key, None)
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
            node.parent = None

    def _deregister_segment_of(self, blk: int) -> None:
        """If ``blk`` is compressed-segment payload, drop the whole segment
        registration. Peer payload blocks already parked in ``cached_free``
        lose their cache claim and return to the raw free list."""
        seg = self.seg_of_block.get(blk)
        if seg is None:
            return
        self.segments.pop(seg.key, None)
        self._seg_tokens -= seg.n_tokens
        for p in seg.blocks:
            self.seg_of_block.pop(p, None)
            if p in self.cached_free and p not in self.block_hash:
                del self.cached_free[p]
                self.free.append(p)

    def _evict_lru_leaf(self) -> Optional[int]:
        """Radix eviction: oldest unreferenced *leaf* (a cached block no
        cached chain extends), or an oldest whole segment. Interior nodes
        are skipped — a shared prefix outlives its suffixes. Always finds a
        victim when ``cached_free`` is non-empty: every holder of a cached
        node holds its whole root path, so an unreferenced node's
        descendants are unreferenced too and the scan reaches a leaf."""
        for blk in self.cached_free:
            node = self.node_of_block.get(blk)
            if node is not None and not node.children:
                del self.cached_free[blk]
                self._drop_node(node)
                self.n_evicted_blocks += 1
                return blk
            seg = self.seg_of_block.get(blk)
            if seg is not None \
                    and all(b in self.cached_free for b in seg.blocks):
                self.segments.pop(seg.key, None)
                self._seg_tokens -= seg.n_tokens
                for b in seg.blocks:
                    self.seg_of_block.pop(b, None)
                    del self.cached_free[b]
                    if b != blk:
                        self.free.append(b)
                self.n_evicted_blocks += len(seg.blocks)
                return blk
        return None

    def _pop_block(self) -> int:
        if self.free:
            return self.free.pop()
        if self._radix:
            blk = self._evict_lru_leaf()
            if blk is not None:
                return blk
        if self.cached_free:
            blk, _ = self.cached_free.popitem(last=False)   # evict oldest
            self._deregister_block(blk)
            self._deregister_segment_of(blk)
            self.n_evicted_blocks += 1
            return blk
        raise OutOfBlocks()

    def can_allocate(self, n: int, margin: int = 0) -> bool:
        """True if ``n`` blocks can be handed out while still leaving
        ``margin`` free. The scheduler's compression-aware admission passes
        the projected post-compression growth of the running batch as the
        margin (docs/SCHEDULER.md)."""
        return self.num_free >= n + margin

    @property
    def utilization(self) -> float:
        return 1.0 - self.num_free / self.num_blocks

    def allocate(self, n: int) -> List[int]:
        if not self.can_allocate(n):
            raise OutOfBlocks()
        blocks = [self._pop_block() for _ in range(n)]
        for b in blocks:
            self.ref[b] = 1
        return blocks

    def fork(self, block: int) -> int:
        """Add a reference to a shared block."""
        assert self.ref[block] >= 1
        self.ref[block] += 1
        return block

    def release(self, blocks: Sequence[int]) -> None:
        for b in blocks:
            assert self.ref[b] > 0, f"double free of block {b}"
            self.ref[b] -= 1
            if self.ref[b] == 0:
                cached = b in self.block_hash or b in self.seg_of_block
                if cached and self.enable_prefix_cache:
                    self.cached_free[b] = None      # keep contents reusable
                else:
                    if cached:
                        # prefix cache toggled off at runtime (e.g. a
                        # snapshot/restore round trip): drop the hash /
                        # segment registration symmetrically instead of
                        # leaving stale entries pointing at a free block
                        self._deregister_block(b)
                        self._deregister_segment_of(b)
                    self.free.append(b)
        self._enforce_watermark()

    def _enforce_watermark(self) -> None:
        """Cap unreferenced cached blocks at ``prefix_cache_watermark *
        num_blocks``, evicting LRU (leaf-first under radix) beyond it.
        1.0 — the default — disables the cap: cached blocks are only
        reclaimed under allocation pressure."""
        if self.prefix_cache_watermark >= 1.0:
            return
        limit = int(self.prefix_cache_watermark * self.num_blocks)
        while len(self.cached_free) > limit:
            blk = self._evict_lru_leaf() if self._radix else None
            if blk is None:
                if not self.cached_free:
                    break
                blk, _ = self.cached_free.popitem(last=False)
                self._deregister_block(blk)
                self._deregister_segment_of(blk)
                self.n_evicted_blocks += 1
            self.free.append(blk)

    # ------------------------------------------------------------------
    # prefix cache

    @staticmethod
    def chain_hash(prev_hash: int, tokens: Tuple[int, ...]) -> int:
        return hash((prev_hash, tokens))

    def _block_chain(self, token_ids: Sequence[int]) -> List[int]:
        bs = self.block_size
        chain: List[int] = []
        h = 0
        for i in range(len(token_ids) // bs):
            h = self.chain_hash(h, tuple(token_ids[i * bs:(i + 1) * bs]))
            chain.append(h)
        return chain

    def _claim(self, blocks: Sequence[int]) -> None:
        """Take a reference on matched blocks, resurrecting any that were
        parked unreferenced (which also refreshes their LRU recency)."""
        for blk in blocks:
            if blk in self.cached_free:
                del self.cached_free[blk]
            self.ref[blk] += 1

    def lookup_prefix(self, token_ids: Sequence[int]):
        """Longest cached prefix of FULL blocks (legacy exact-match API).

        Returns (blocks, n_tokens_matched, chain) where chain is the list of
        hashes for all full blocks of the prompt (for later registration).
        Unlike :meth:`lookup_prefix_ex` this never caps a full-prompt match
        and never consults compressed segments — it is byte-for-byte the
        pre-radix behavior.
        """
        bs = self.block_size
        chain, blocks = [], []
        h = 0
        n_full = len(token_ids) // bs
        matched = True
        n_matched = 0
        self.n_lookups += 1
        for i in range(n_full):
            h = self.chain_hash(h, tuple(token_ids[i * bs:(i + 1) * bs]))
            chain.append(h)
            if matched and self.enable_prefix_cache and h in self.hash_to_block:
                blk = self.hash_to_block[h]
                if blk in self.cached_free:          # resurrect
                    del self.cached_free[blk]
                self.ref[blk] += 1
                blocks.append(blk)
                n_matched += bs
            else:
                matched = False
        if n_matched:
            self.n_hits += 1
            self.n_hit_tokens += n_matched
        return blocks, n_matched, chain

    def lookup_prefix_ex(self, token_ids: Sequence[int],
                         allow_compressed: bool = False) -> PrefixMatch:
        """Longest-prefix match over the radix tree, optionally including
        compressed segments. References are taken on the returned blocks.

        Radix refinement over :meth:`lookup_prefix`: a match covering the
        *entire* prompt is capped one block short, so the final prefill
        chunk always carries at least one real token and the first sampled
        token comes from the true last-prompt-token query — cache-hit
        streams stay bit-identical to cache-miss streams.

        With ``allow_compressed``, a registered segment beats the exact
        match when it covers more tokens; the caller sees
        ``n_entries < n_tokens`` and must thread the position gap through
        prefill (``Request.pos_gap``).
        """
        chain = self._block_chain(token_ids)
        self.n_lookups += 1
        bs = self.block_size
        n_exact = 0
        if self.enable_prefix_cache:
            for h in chain:
                if h in self.hash_to_block:
                    n_exact += 1
                else:
                    break
        if self._radix and n_exact and n_exact * bs >= len(token_ids):
            n_exact -= 1                 # full-prompt hit: leave one chunk
        seg = None
        if allow_compressed and self._radix and self.enable_prefix_cache:
            for j in range(len(chain) - 1, -1, -1):
                s = self.segments.get(chain[j])
                if s is not None and s.n_tokens == (j + 1) * bs \
                        and s.n_tokens < len(token_ids) \
                        and s.n_tokens > n_exact * bs:
                    seg = s
                    break
        if seg is not None:
            self._claim(seg.blocks)
            self.n_hits += 1
            self.n_segment_hits += 1
            self.n_hit_tokens += seg.n_tokens
            return PrefixMatch(list(seg.blocks), seg.n_tokens,
                               len(seg.blocks) * bs, chain, True)
        blocks = [self.hash_to_block[h] for h in chain[:n_exact]]
        self._claim(blocks)
        if n_exact:
            self.n_hits += 1
            self.n_hit_tokens += n_exact * bs
        return PrefixMatch(blocks, n_exact * bs, n_exact * bs, chain, False)

    def probe_prefix(self, token_ids: Sequence[int],
                     allow_compressed: bool = False) -> int:
        """Side-effect-free probe: prompt tokens a lookup would cover. No
        references taken, no LRU touch, no counters — the ``cache_aware``
        admission policy calls this per waiting request per step."""
        if not self.enable_prefix_cache:
            return 0
        chain = self._block_chain(token_ids)
        n_exact = 0
        for h in chain:
            if h in self.hash_to_block:
                n_exact += 1
            else:
                break
        best = n_exact * self.block_size
        if allow_compressed and self._radix:
            for j in range(len(chain) - 1, -1, -1):
                s = self.segments.get(chain[j])
                if s is not None and s.n_tokens < len(token_ids):
                    best = max(best, s.n_tokens)
                    break
        return min(best, max(0, len(token_ids) - 1))

    def register_prefix(self, blocks: Sequence[int], chain: Sequence[int],
                        start_block: int) -> None:
        """Register newly-filled full blocks under their chain hashes. Under
        the radix policy each registration also inserts a tree node chained
        to its parent block's node (registration of a block whose ancestor
        chain was evicted is skipped — the tree never holds dangling
        paths)."""
        if not self.enable_prefix_cache:
            return
        for i, h in enumerate(chain[start_block:], start=start_block):
            if i >= len(blocks):
                break
            blk = blocks[i]
            if h in self.hash_to_block or blk in self.block_hash \
                    or blk in self.seg_of_block:
                continue
            if self._radix:
                parent = self.nodes.get(chain[i - 1]) if i > 0 else None
                if i > 0 and parent is None:
                    continue
                node = _RadixNode(h, blk, parent)
                self.nodes[h] = node
                self.node_of_block[blk] = node
                if parent is not None:
                    parent.children[h] = node
            self.hash_to_block[h] = blk
            self.block_hash[blk] = h

    def register_segment(self, key: int, blocks: Sequence[int],
                         n_tokens: int) -> None:
        """Cache a compressed prefix (radix policy only): ``blocks`` hold
        the condensed KV of the first ``n_tokens`` prompt tokens, keyed by
        the chain hash of the last full block the span covers. No-op if the
        key is already cached or a payload block is otherwise registered."""
        if not self.enable_prefix_cache or not self._radix:
            return
        if n_tokens <= 0 or key in self.segments:
            return
        if any(b in self.block_hash or b in self.seg_of_block
               for b in blocks):
            return
        seg = _Segment(key, list(blocks), n_tokens)
        self.segments[key] = seg
        for b in blocks:
            self.seg_of_block[b] = seg
        self._seg_tokens += n_tokens

    def invalidate_blocks(self, blocks: Sequence[int]) -> None:
        """Drop every cache registration naming ``blocks`` — called before
        their payload is overwritten (in-place compression dest/reserved
        blocks). A dropped radix node takes its whole subtree with it
        (descendants are only reachable through the parent chain); orphaned
        descendants are provably unreferenced, so their blocks move from
        ``cached_free`` straight to the free list."""
        for b in blocks:
            self._deregister_segment_of(b)
            node = self.node_of_block.get(b)
            if node is not None:
                self._drop_subtree(node)
            elif b in self.block_hash:
                self._deregister_block(b)
                self.n_invalidated_blocks += 1

    def _drop_subtree(self, node: _RadixNode) -> None:
        for child in list(node.children.values()):
            self._drop_subtree(child)
        blk = node.block
        self._drop_node(node)
        self.n_invalidated_blocks += 1
        if blk in self.cached_free and blk not in self.seg_of_block:
            del self.cached_free[blk]
            self.free.append(blk)

    def is_shared(self, block: int) -> bool:
        return self.ref[block] > 1

    def is_cow_protected(self, block: int) -> bool:
        """True if overwriting ``block`` in place would corrupt another
        reader: it is shared (ref > 1), it serves as cached
        compressed-segment payload, or — under the radix policy — it is
        registered in the prefix tree (cached content is immutable; a
        later request may claim it at any time). Compression planning
        treats protected blocks like shared prefix blocks and copies into
        fresh dest blocks instead (copy-on-write), so the cached prefix
        outlives the compression that condensed it."""
        if self.ref[block] > 1 or block in self.seg_of_block:
            return True
        return self._radix and block in self.block_hash

    def cache_stats(self) -> dict:
        """Cumulative prefix-cache telemetry (merged into
        ``Scheduler.stats()`` -> ``Zipage.scheduler_stats``).
        ``cached_tokens_per_block`` is the effective-capacity headline: a
        full-KV cache pins it at ``block_size``, compressed segments push
        it above (docs/PERF.md "Effective prefix-cache capacity")."""
        n_blocks = len(self.block_hash) + len(self.seg_of_block)
        n_tokens = self.block_size * len(self.block_hash) + self._seg_tokens
        return {
            "prefix_cache_policy": self.prefix_cache_policy,
            "prefix_lookups": self.n_lookups,
            "prefix_hits": self.n_hits,
            "prefix_hit_tokens": self.n_hit_tokens,
            "prefix_segment_hits": self.n_segment_hits,
            "prefix_evictions": self.n_evicted_blocks,
            "prefix_cached_blocks": n_blocks,
            "prefix_cached_tokens": n_tokens,
            "cached_tokens_per_block":
                (n_tokens / n_blocks) if n_blocks else 0.0,
        }

    # ------------------------------------------------------------------
    # host swap tier

    @property
    def swap_util(self) -> float:
        if not self.swap_space_blocks:
            return 0.0
        return 1.0 - len(self.swap_free) / self.swap_space_blocks

    def can_swap_out(self, n: int) -> bool:
        return 0 < n <= len(self.swap_free)

    def swap_out(self, rid: int, n: int) -> List[int]:
        """Reserve ``n`` host blocks for ``rid``'s KV copy. The caller
        copies the device blocks out *before* releasing them (the device
        side stays ref-counted: shared blocks merely drop one ref)."""
        assert rid not in self.swapped, f"rid {rid} already swapped out"
        if not self.can_swap_out(n):
            raise OutOfBlocks()
        host = [self.swap_free.pop() for _ in range(n)]
        self.swapped[rid] = host
        return host

    def swapped_blocks(self, rid: int) -> List[int]:
        return list(self.swapped[rid])

    def n_swapped_blocks(self, rid: int) -> int:
        return len(self.swapped[rid])

    def release_swapped(self, rid: int) -> None:
        """Return ``rid``'s host blocks to the swap pool (after swap-in
        copied them back, or on abort of a swapped request)."""
        self.swap_free.extend(self.swapped.pop(rid))

    # invariant checks (used by property tests)
    def check_invariants(self) -> None:
        live = [b for b in range(self.num_blocks) if self.ref[b] > 0]
        free_set = set(self.free) | set(self.cached_free)
        assert len(free_set) == len(self.free) + len(self.cached_free)
        assert free_set.isdisjoint(live)
        assert len(live) + len(free_set) == self.num_blocks
        # hash <-> block bijection, both directions
        for h, b in self.hash_to_block.items():
            assert self.block_hash.get(b) == h
        for b, h in self.block_hash.items():
            assert self.hash_to_block.get(h) == b
        # no registered (cached) block on the raw free list, and every
        # unreferenced cached block is actually registered somewhere
        raw_free = set(self.free)
        assert raw_free.isdisjoint(self.block_hash)
        assert raw_free.isdisjoint(self.seg_of_block)
        for b in self.cached_free:
            assert b in self.block_hash or b in self.seg_of_block
        # radix tree audit
        if self._radix:
            assert set(self.nodes) == set(self.hash_to_block)
            assert len(self.node_of_block) == len(self.nodes)
            for h, node in self.nodes.items():
                assert node.key == h
                assert self.hash_to_block[h] == node.block
                assert self.node_of_block.get(node.block) is node
                if node.parent is not None:
                    assert node.parent.children.get(h) is node
                    # path closure: a referenced node's parent is referenced
                    if self.ref[node.block] > 0:
                        assert self.ref[node.parent.block] > 0
                for ck, child in node.children.items():
                    assert child.parent is node
                    assert self.nodes.get(ck) is child
        else:
            assert not self.nodes and not self.segments
        # segments: consistent maps, all-or-none holders
        n_payload = 0
        for key, seg in self.segments.items():
            assert seg.key == key
            n_payload += len(seg.blocks)
            assert len({self.ref[b] for b in seg.blocks}) == 1
            for b in seg.blocks:
                assert self.seg_of_block.get(b) is seg
                assert b not in self.block_hash
        assert n_payload == len(self.seg_of_block)
        assert self._seg_tokens == sum(s.n_tokens
                                       for s in self.segments.values())
        # swap pool: free + per-rid reservations partition the host blocks
        held = [b for blocks in self.swapped.values() for b in blocks]
        swap_all = set(self.swap_free) | set(held)
        assert len(swap_all) == len(self.swap_free) + len(held)
        assert len(swap_all) == self.swap_space_blocks
