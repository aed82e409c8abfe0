"""Host<->device weight streaming: the offload tier of the paper's
system on one card (the port of ``repro/core/offload.py``).

* The target's layers at rest live in page-locked host memory, one
  buffer a layer (the paper's CPU DRAM tier); the embedding and the
  final norm (small, reused every step) stay on the device, as in the
  JAX package.  On the CPU (``device="cpu"``) the layers are plain CPU
  tensors and the same code runs with synchronous copies.
* A pass (prefill or decode) streams the stack through two device slots,
  the placement plan's ``target/stream_slot0`` / ``stream_slot1``:
  layer ``l + 1`` is copied on a copy stream while layer ``l`` computes,
  and the compute stream waits on a per-layer event before it reads a
  slot.  At most two layers' weights are on the device at a time.  The
  JAX package's ``stream_layers`` moves the whole stack in one copy that
  XLA overlaps with compute; a full-depth Mixtral 8x7B (86.5 GiB) cannot
  be resident on an 80 GB card, so here the stack moves layer by layer,
  computing the same values in the same order.
* The model code is unchanged: :class:`StreamedLayers` is the
  ``params["layers"]`` sequence ``forward_decoder`` indexes, in order,
  once per layer.
* :func:`host_attention_direct` computes decode attention next to a
  host-resident KV cache: only q and the output cross the link.

Transfers are accounted per tier ("h2d", "d2h") by
:func:`record_transfer` into the ``transfer_bytes_total`` /
``transfer_seconds_total`` counters of the model's ``obs`` (and a span on
the tier's trace track), as in the JAX package, and in the plain dict
``OffloadedModel.transfers`` kept beside them (:func:`add_transfer`);
link seconds come from CUDA events around the copies, read back by
:meth:`OffloadedModel.settle` after a pass, so no pass waits on the host.
"""
from __future__ import annotations

import time
import weakref

import torch

from repro_torch.configs import ModelConfig, resolve_device
from repro_torch.models import model as M
from repro_torch.models.attention import attention_direct
from repro_torch.obs import NULL_OBS
from repro_torch.params import init_layer, init_resident
from repro_torch.tree import tree_leaves, tree_map

# byte alignment of each tensor inside a layer's host buffer and slot
# (the kernels need 16; 256 keeps every view as aligned as the caching
# allocator's own blocks, so a product sees the same alignment either way)
ALIGN = 256


def _leaves(tree, prefix=()):
    """(path, tensor) of nested dicts / lists of tensors, in order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _layout(tree) -> tuple:
    """([(path, shape, dtype, byte offset)], buffer bytes) of one buffer
    holding every leaf of ``tree`` at ``ALIGN``-byte offsets."""
    entries, off = [], 0
    for path, t in _leaves(tree):
        off = -(-off // ALIGN) * ALIGN
        entries.append((path, tuple(t.shape), t.dtype, off))
        off += t.numel() * t.element_size()
    return entries, off


def _views(flat: torch.Tensor, entries) -> dict:
    """The nested dict of typed views that ``entries`` lays over the
    uint8 buffer ``flat``."""
    tree: dict = {}
    for path, shape, dtype, off in entries:
        n = torch.Size(shape).numel() * dtype.itemsize
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = flat[off:off + n].view(dtype).view(shape)
    return tree


def host_memory_kind(device="cuda") -> str:
    """The memory the host tier maps to for ``device``: page-locked
    ('pinned_host') beside a card, plain CPU memory ('unpinned_host')
    when the caller runs on the CPU."""
    return ("pinned_host" if resolve_device(device).type == "cuda"
            else "unpinned_host")


class PinnedBuffer:
    """``nbytes`` of page-locked host memory as a uint8 tensor.

    The buffer is a plain CPU allocation registered with
    ``cudaHostRegister``, exactly ``nbytes`` long: ``Tensor.pin_memory``
    goes through PyTorch's caching host allocator, which rounds a block
    up to a power of two, so a 2.7 GiB Mixtral layer would take 4 GiB
    and 32 layers would not fit the host.  Registration either succeeds
    or raises; there is no pageable fallback.
    """

    def __init__(self, nbytes: int):
        torch.cuda.init()
        self.tensor = torch.empty(nbytes, dtype=torch.uint8)
        rt = torch.cuda.cudart()
        err = rt.cudaHostRegister(self.tensor.data_ptr(), nbytes, 0)
        if err != rt.cudaError.success:
            raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: "
                               f"{rt.cudaGetErrorString(err)}")
        self._finalizer = weakref.finalize(self, _unregister,
                                           self.tensor.data_ptr())
        if not self.tensor.is_pinned():
            self.close()
            raise RuntimeError("registered host buffer is not page-locked")

    def close(self) -> None:
        self._finalizer()


def _unregister(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


def _host_buffer(nbytes: int, device) -> tuple:
    """(uint8 host buffer, its ``PinnedBuffer`` or None) of the offload
    tier for ``device``."""
    if resolve_device(device).type == "cuda":
        owner = PinnedBuffer(nbytes)
        return owner.tensor, owner
    return torch.empty(nbytes, dtype=torch.uint8), None


def put_host(tree, device="cuda", account=None) -> tuple:
    """Copy a nested dict of tensors into one host buffer of the offload
    tier: page-locked beside a card, plain CPU memory on the CPU.
    Returns (flat uint8 buffer, the tree as views into it, the
    ``PinnedBuffer`` owning the memory or None).  A copy from the
    device is timed on its own (after the buffer is page-locked and the
    work that made the tree is done) and, with ``account`` (called as
    ``account(tier, nbytes, seconds)``), recorded as a "d2h" transfer."""
    entries, nbytes = _layout(tree)
    flat, owner = _host_buffer(nbytes, device)
    views = _views(flat, entries)
    on_dev = any(t.is_cuda for _, t in _leaves(tree))
    if on_dev:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for (_, t), (_, view) in zip(_leaves(tree), _leaves(views)):
        view.copy_(t)
    if on_dev and account is not None:
        account("d2h", nbytes, time.perf_counter() - t0)
    return flat, views, owner


def put_device(tree, device="cuda"):
    return tree_map(lambda t: t.to(resolve_device(device)), tree)


def record_transfer(obs, tier: str, nbytes: float, seconds: float,
                    what: str = "transfer"):
    """Account one tier transfer in the metrics registry + trace.

    ``tier`` names the link direction ("h2d", "d2h"); bytes and seconds
    feed the ``transfer_bytes_total`` / ``transfer_seconds_total``
    counters, and a completed span lands on the matching trace track.
    """
    if not obs.enabled:
        return
    obs.metrics.counter(
        "transfer_bytes_total",
        "bytes moved across the offload link per tier").inc(
            float(nbytes), tier=tier)
    obs.metrics.counter(
        "transfer_seconds_total",
        "wall seconds spent on offload-link transfers per tier").inc(
            max(float(seconds), 0.0), tier=tier)
    if obs.tracer.enabled:
        t1 = time.perf_counter()
        obs.tracer.complete(tier, what, t1 - seconds, t1,
                            args={"bytes": float(nbytes)})


def add_transfer(transfers: dict, tier: str, nbytes: float,
                 seconds: float) -> None:
    """Add one tier transfer to a plain per-tier dict
    ``{tier: {"bytes", "seconds"}}`` (the tally kept beside the
    counters, readable without a registry)."""
    acc = transfers.setdefault(tier, {"bytes": 0.0, "seconds": 0.0})
    acc["bytes"] += float(nbytes)
    acc["seconds"] += max(float(seconds), 0.0)


class OffloadedModel:
    """A model whose layers stream from host memory per pass.

    ``layers_host`` holds the layers at rest (host tensors);
    ``params_resident`` the embedding, the final norm and an
    encoder-decoder config's encoder on the device.
    Build it from a params dict (``init_params`` or ``from_jax`` weights)
    or, for a target larger than the card, with :meth:`from_seed`, which
    draws each layer on the device and parks it before drawing the next.
    """

    def __init__(self, cfg: ModelConfig, params: dict, device="cuda",
                 obs=None):
        self._setup(cfg, device, obs)
        for layer in params["layers"]:
            self._park(layer)
        self.params_resident = put_device(
            {k: v for k, v in params.items() if k != "layers"}, self.device)
        self._make_slots()

    @classmethod
    def from_seed(cls, cfg: ModelConfig, generator: torch.Generator,
                  device="cuda", obs=None) -> "OffloadedModel":
        """The weights ``init_params(cfg, generator, device)`` would draw,
        drawn layer by layer on ``device`` (where ``generator`` lives) and
        parked in host memory one at a time, so the device never holds
        more than one layer of them."""
        om = cls.__new__(cls)
        om._setup(cfg, device, obs)
        for l in range(cfg.n_layers):
            om._park(init_layer(cfg, l, generator, om.device))
        om.params_resident = init_resident(cfg, generator, om.device)
        om._make_slots()
        return om

    # -- parking -----------------------------------------------------------

    def _setup(self, cfg: ModelConfig, device, obs) -> None:
        self.cfg = cfg
        self.device = resolve_device(device)
        self.on_card = self.device.type == "cuda"
        self.obs = obs if obs is not None else NULL_OBS
        self.transfers: dict = {}
        # the compute stream's span per layer, from the point it may read
        # the layer (copy landed, layer l - 1 done) to the layer's last
        # kernel, summed: device work, plus any wait for the host to
        # queue the layer's launches
        self.compute_seconds = 0.0
        self.layers_host: list = []     # per layer: the tree of host views
        self._flat: list = []           # per layer: its host buffer
        self._entries: list = []        # per layer: its buffer layout
        self._owners: list = []         # page-locked buffers to release
        self._pending: list = []        # (tier, bytes, start, end) events
        self._busy: list = []           # (start, end) compute events
        self._copy_stream = (torch.cuda.Stream(self.device) if self.on_card
                             else None)

    def _account(self, tier: str, nbytes: float, seconds: float) -> None:
        """One transfer into ``transfers`` and the ``obs`` counters."""
        add_transfer(self.transfers, tier, nbytes, seconds)
        record_transfer(self.obs, tier, nbytes, seconds,
                        what="layer_stream" if tier == "h2d" else "park")

    def _park(self, layer: dict) -> None:
        flat, views, owner = put_host(layer, self.device, self._account)
        self._flat.append(flat)
        self._entries.append(_layout(layer)[0])
        self.layers_host.append(views)
        if owner is not None:
            self._owners.append(owner)

    def _make_slots(self) -> None:
        """The two device slots, each as large as the largest layer, and
        every layer's typed views into the slot it streams through."""
        size = max(f.numel() for f in self._flat)
        self._slots = [torch.empty(size, dtype=torch.uint8,
                                   device=self.device) for _ in range(2)]
        self._slot_views = [_views(self._slots[l % 2], e)
                            for l, e in enumerate(self._entries)]

    def close(self) -> None:
        """Wait for the copies in flight, then release the host tier."""
        if self.on_card:
            torch.cuda.synchronize(self.device)
        for owner in self._owners:
            owner.close()
        self._owners, self._flat, self.layers_host = [], [], []
        self._slots, self._slot_views = [], []

    # -- streamed forward ----------------------------------------------------

    def _copy(self, l: int, after) -> object:
        """Issue the host->device copy of layer ``l`` into its slot once the
        compute stream has passed ``after`` (the slot's last reader).
        Returns the event that marks the copy done (None on the CPU)."""
        src = self._flat[l]
        dst = self._slots[l % 2][:src.numel()]
        if not self.on_card:
            t0 = time.perf_counter()
            dst.copy_(src)
            self._account("h2d", src.numel(), time.perf_counter() - t0)
            return None
        start = torch.cuda.Event(enable_timing=True)
        done = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(after)
            start.record()
            dst.copy_(src, non_blocking=True)
            done.record()
        self._pending.append(("h2d", src.numel(), start, done))
        return done

    def stream_layers(self) -> "StreamedLayers":
        """The layer stack for one pass, streamed through the slots (the
        counterpart of the JAX package's per-step stream)."""
        return StreamedLayers(self)

    def _assemble(self, layers) -> dict:
        p = dict(self.params_resident)
        p["layers"] = layers
        return p

    def prefill(self, tokens, cache, encoder_frames=None):
        """As ``M.prefill``; an encoder-decoder config's encoder (resident)
        runs over ``encoder_frames`` (the JAX package's ``prefill`` takes
        the frames and drops them)."""
        layers = self.stream_layers()
        out = M.prefill(self._assemble(layers), self.cfg, tokens, cache,
                        encoder_frames=encoder_frames)
        layers.finish()
        return out

    def decode(self, cache, tokens):
        """(logits (B, m, V), cache, pendings), as ``M.decode``; finalize
        with ``M.commit``."""
        layers = self.stream_layers()
        out = M.decode(self._assemble(layers), self.cfg, cache, tokens)
        layers.finish()
        return out

    def streamed_bytes(self) -> int:
        return tree_bytes(self.layers_host)

    def settle(self) -> dict:
        """Wait for the copies issued so far and add their bytes and link
        seconds (CUDA events) to ``transfers``, and the layers' compute
        spans to ``compute_seconds``.  Returns ``transfers``."""
        for tier, nbytes, start, done in self._pending:
            done.synchronize()
            self._account(tier, nbytes, start.elapsed_time(done) / 1e3)
        for start, done in self._busy:
            done.synchronize()
            self.compute_seconds += start.elapsed_time(done) / 1e3
        self._pending, self._busy = [], []
        return self.transfers


class StreamedLayers:
    """``params["layers"]`` of one streamed pass: ``forward_decoder``
    reads layer ``l`` once, in order.  Reading layer ``l`` marks layer
    ``l - 1``'s compute enqueued (its slot may be overwritten once the
    compute stream passes that point), issues the copy of layer ``l + 1``
    into that slot, and makes the compute stream wait for layer ``l``'s
    copy.  Call :meth:`finish` after the pass."""

    def __init__(self, model: OffloadedModel):
        self.m = model
        self.n = len(model._flat)
        self.next = 0
        self.ready = [None] * self.n
        self.started = None
        if model.on_card:
            self.stream = torch.cuda.current_stream(model.device)
            # the slots' last readers: everything the compute stream has
            # been given so far (the previous pass included)
            begin = self.stream.record_event()
        else:
            self.stream = begin = None
        for l in range(min(2, self.n)):
            self.ready[l] = model._copy(l, begin)

    def _layer_done(self, l: int):
        if self.stream is None:
            return None
        done = torch.cuda.Event(enable_timing=True)
        done.record(self.stream)
        self.m._busy.append((self.started, done))
        return done

    def __getitem__(self, l: int) -> dict:
        if l != self.next:
            raise IndexError(f"streamed layers are read once, in order: "
                             f"asked for {l}, next is {self.next}")
        if l > 0:
            freed = self._layer_done(l - 1)
            if l + 1 < self.n:
                self.ready[l + 1] = self.m._copy(l + 1, freed)
        if self.stream is not None:
            self.stream.wait_event(self.ready[l])
            self.started = torch.cuda.Event(enable_timing=True)
            self.started.record(self.stream)
        self.next += 1
        return self.m._slot_views[l]

    def finish(self) -> None:
        if self.next != self.n:
            raise RuntimeError(f"pass read {self.next} of {self.n} layers")
        self._layer_done(self.n - 1)


# ---------------------------------------------------------------------------
# host-offloaded decode attention (the CPU-attention analogue)


def host_attention_direct(q, k, v, mask, scale):
    """Decode attention computed where the KV cache lives (host memory):
    q (B,Sq,Hq,d) and the mask go to ``k``'s device, the plain
    ``attention_direct`` runs there, and the output (B, Sq, Hq*d) returns
    to q's device.  Only q and the output cross the link — the KV cache
    never moves, as in the paper's CPU attention."""
    host = k.device
    out = attention_direct(q.to(host), k, v, mask.to(host), scale)
    return out.to(q.device)
