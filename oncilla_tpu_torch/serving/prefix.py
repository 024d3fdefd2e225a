"""Cross-tenant prefix-cache sharing: a content-hash radix over KV pages,
the port's copy of ``oncilla_tpu/serving/prefix.py``.

Identical prompt prefixes across tenants dedup into shared, read-only,
refcounted extents: one KV page computed and stored once, attended to by
every tenant whose prompt starts the same way. The structure is a radix
trie at page granularity: each node covers one page of token ids (the last
node of a published prompt may be *partial*), children are keyed by their
token chunk, and every node carries a chain content hash (SHA-1 over the
parent's hash and this node's tokens), so an extent's identity is the
content of the whole prefix, never a tenant.

Sharing rules: an extent's page is ``shared``; while ``refs > 0`` it is
immutable (``TieredPageStore.write_page`` refuses) and unevictable; a
tenant that appends into a partial shared extent copies it first
(``TieredPageStore.cow``); ``refs == 0`` extents stay cached until
:meth:`PrefixCache.sweep` reclaims unreferenced leaves.

Warm boot: :meth:`PrefixCache.persist` writes every extent's page bytes and
trie position into a FROZEN store under ``prefix-<chainhash>`` keys (the
JAX package's chain hashes and meta, so a trie persisted by one package is
restored by the other), and :meth:`PrefixCache.restore` re-publishes them
parents first, each page uploaded to the card as one ``alloc_page``.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import torch

from oncilla_tpu_torch.core.errors import OcmError
from oncilla_tpu_torch.obs import journal as obs_journal
from oncilla_tpu_torch.serving.metrics import ServingStats
from oncilla_tpu_torch.serving.tiers import Page, TieredPageStore
from oncilla_tpu_torch.utils.debug import printd


def _chain_hash(parent_key: str, tokens: tuple[int, ...]) -> str:
    h = hashlib.sha1(parent_key.encode("ascii"))
    h.update(b"\x00".join(str(t).encode("ascii") for t in tokens))
    return h.hexdigest()


@dataclass
class SharedExtent:
    """One radix node: a page of KV for one page of prefix tokens."""

    key: str
    tokens: tuple[int, ...]
    page: Page
    parent: "SharedExtent | None" = None
    children: dict = field(default_factory=dict)   # full-page nodes
    partials: dict = field(default_factory=dict)   # partial-tail nodes

    @property
    def fill(self) -> int:
        return len(self.tokens)

    @property
    def refs(self) -> int:
        return self.page.refs


class PrefixCache:
    """The page-granular radix trie over one :class:`TieredPageStore`."""

    def __init__(self, store: TieredPageStore, page_tokens: int,
                 stats: ServingStats | None = None):
        self.store = store
        self.page_tokens = int(page_tokens)
        self.stats = stats or store.stats
        self._root = SharedExtent(key="", tokens=(), page=None)  # sentinel

    # -- lookup -----------------------------------------------------------

    def match(self, tokens) -> tuple[list[SharedExtent], int]:
        """Longest shared prefix of ``tokens``: full-page extents chunk
        by chunk, then (when what remains is a short tail) an exact
        partial extent. Returns (extents, tokens_matched); the caller
        must :meth:`acquire` before using any page."""
        toks = tuple(int(t) for t in tokens)
        node = self._root
        matched: list[SharedExtent] = []
        i = 0
        P = self.page_tokens
        while i + P <= len(toks):
            child = node.children.get(toks[i:i + P])
            if child is None:
                break
            matched.append(child)
            node = child
            i += P
        rest = toks[i:]
        if 0 < len(rest) < P:
            part = node.partials.get(rest)
            if part is not None:
                matched.append(part)
                i += len(rest)
        return matched, i

    def child(self, parent: SharedExtent | None, tokens) -> SharedExtent | None:
        """The single extent extending ``parent`` by exactly ``tokens``
        (full-page or partial by length) — the incremental form of
        :meth:`match`, what the engine probes at every page boundary so
        prompts arriving *simultaneously* still dedup: session B adopts
        the page session A published one turn earlier."""
        node = parent or self._root
        toks = tuple(int(t) for t in tokens)
        table = (node.children if len(toks) == self.page_tokens
                 else node.partials)
        return table.get(toks)

    # -- publication ------------------------------------------------------

    def publish(self, parent: SharedExtent | None, tokens, page: Page
                ) -> SharedExtent:
        """Publish ``page`` as the KV for ``tokens`` extending
        ``parent`` (None = the prompt's first page). Content-hash
        dedup: when the chain already carries this exact extent —
        another tenant prefilled the same prefix first — the fresh page
        is returned to the store and the existing extent wins, so the
        cache can never hold two copies of one prefix."""
        node = parent or self._root
        toks = tuple(int(t) for t in tokens)
        if not 0 < len(toks) <= self.page_tokens:
            raise ValueError(f"extent of {len(toks)} tokens "
                             f"(page is {self.page_tokens})")
        table = (node.children if len(toks) == self.page_tokens
                 else node.partials)
        existing = table.get(toks)
        if existing is not None:
            if page is not existing.page:
                self.store.free_page(page)
            return existing
        page.shared = True
        ext = SharedExtent(
            key=_chain_hash(node.key, toks), tokens=toks, page=page,
            parent=None if node is self._root else node,
        )
        table[toks] = ext
        self.stats.note_extents(+1)
        obs_journal.record("prefix_publish", key=ext.key[:12],
                           tokens=len(toks), nbytes=page.nbytes,
                           partial=len(toks) < self.page_tokens)
        return ext

    # -- refcounts --------------------------------------------------------

    def acquire(self, ext: SharedExtent) -> None:
        ext.page.refs += 1
        self.stats.note_prefix_hit(ext.page.nbytes)
        obs_journal.record("prefix_hit", key=ext.key[:12],
                           refs=ext.page.refs, nbytes=ext.page.nbytes)

    def release(self, ext: SharedExtent) -> None:
        if ext.page.refs <= 0:
            raise ValueError(f"release of unreferenced extent {ext.key[:12]}")
        ext.page.refs -= 1
        self.stats.note_prefix_release(ext.page.nbytes)

    # -- retention --------------------------------------------------------

    def _walk(self, node: SharedExtent):
        for table in (node.children, node.partials):
            for ext in table.values():
                yield ext
                yield from self._walk(ext)

    def extents(self) -> list[SharedExtent]:
        return list(self._walk(self._root))

    def shared_bytes(self) -> int:
        """Bytes deduplicated: each extra reference beyond the first is
        a page some tenant did NOT have to store privately."""
        return sum(max(e.page.refs - 1, 0) * e.page.nbytes
                   for e in self.extents())

    # -- persistence (the FROZEN tier) ------------------------------------

    def persist(self, frozen) -> int:
        """Write every extent's page bytes + trie position into a
        :class:`~oncilla_tpu_torch.persist.FrozenStore` (``prefix-<chainhash>``
        keys). Parent-first (:meth:`_walk` order) so a restored store is
        always a valid trie prefix even if the write is cut short. A page
        on the card comes down through K2 into the store's pinned staging
        buffer first. Returns the number of extents persisted."""
        n = 0
        live = {f"prefix-{ext.key}" for ext in self.extents()}
        for fkey in frozen.keys():
            # The store is an exact manifest of the trie: a chain swept
            # since the last persist must not resurrect at restore.
            if fkey.startswith("prefix-") and fkey not in live:
                frozen.delete(fkey)
        for ext in self.extents():
            data = self.store.read_host(ext.page)
            frozen.write(
                f"prefix-{ext.key}",
                data.numpy().tobytes(),
                meta={
                    "kind": "prefix",
                    "key": ext.key,
                    "tokens": list(ext.tokens),
                    "parent": ext.parent.key if ext.parent else "",
                    "nbytes": int(ext.page.nbytes),
                },
            )
            n += 1
        obs_journal.record("prefix_persist", extents=n)
        return n

    def restore(self, frozen) -> int:
        """Re-publish persisted extents from ``frozen`` into the trie —
        the warm-boot leg. Parents restore before children (chain-hash
        identity demands it); a chain with a missing or corrupt ancestor
        is dropped WHOLE below the break (a child must never publish over
        a hole — its chain hash would lie about the bytes beneath it).
        Each page goes up as one ``alloc_page`` (K1 on the card).
        Returns the number of extents re-published."""
        recs: dict[str, tuple[str, dict]] = {}
        for fkey in frozen.keys():
            if not fkey.startswith("prefix-"):
                continue
            meta = frozen.meta(fkey)
            if meta.get("kind") == "prefix":
                recs[meta["key"]] = (fkey, meta)

        def depth(key: str) -> int | None:
            d = 0
            while key:
                rec = recs.get(key)
                if rec is None:
                    return None  # broken ancestry: skip the whole chain
                key = rec[1]["parent"]
                d += 1
            return d

        published: dict[str, SharedExtent | None] = {"": None}
        n = 0
        order = sorted(
            (k for k in recs if depth(k) is not None),
            key=lambda k: depth(k),
        )
        for key in order:
            fkey, meta = recs[key]
            parent_key = meta["parent"]
            if parent_key not in published:
                continue  # parent refused at read time below
            try:
                data = frozen.read_bytes(fkey)
            except OcmError:
                # Typed refusal (corrupt entry quarantined by the store):
                # this chain ends here — descendants stay unpublished.
                printd("prefix restore: dropping chain at %s "
                       "(frozen entry refused)", fkey)
                continue
            # A writable host tensor (the file's bytes are read-only).
            page = self.store.alloc_page(
                torch.frombuffer(bytearray(data), dtype=torch.uint8),
                shared=True,
            )
            ext = self.publish(
                published[parent_key], tuple(meta["tokens"]), page
            )
            published[key] = ext
            n += 1
        obs_journal.record("prefix_restore", extents=n,
                           persisted=len(recs))
        return n

    def sweep(self) -> int:
        """Reclaim unreferenced LEAF extents (children first — an inner
        node's page may still back a referenced chain below it).
        Returns the number of pages freed."""
        freed = 0
        changed = True
        while changed:
            changed = False
            for node in [self._root, *self.extents()]:
                for table in (node.children, node.partials):
                    for toks, ext in list(table.items()):
                        if (ext.page.refs == 0 and not ext.children
                                and not ext.partials):
                            del table[toks]
                            ext.page.shared = False
                            self.store.free_page(ext.page)
                            self.stats.note_extents(-1)
                            freed += 1
                            changed = True
        return freed
