"""Step factories + sharding trees for train / prefill / decode (the
reference's ``launch/steps.py``).

The shardings bind the logical rules to a mesh: ``fitted`` gives each
tensor's divisibility-safe spec as a ``NamedSharding``, whose
``shard_shape`` is a position's block shape on any mesh (the dry-run's
production meshes included) and whose ``block`` is the slice a rank of a
live mesh holds. The dry-run, the trainer and the server share these.

``make_train_step`` is the one-card step; ``ShardedTrainStep`` the meshed
one, which keeps each rank's shards of the masters and moments between
steps. ``make_prefill_step`` and ``make_decode_step`` are the one-card
serve steps, and with a rank's ``tensor_parallel`` plan the reference's
meshed ones; ``ShardedServeStep`` holds a rank's slices for them. The
meshed steps take a ``GridMesh`` of live ranks or an
``engine.mesh.StandInMesh`` (one position of a mesh with no ranks behind
it: the dry-run's production meshes, on meta tensors).
"""

from __future__ import annotations

import contextlib
import itertools
import math

import torch

from repro_torch.distributed import tensor_parallel as tp
from repro_torch.distributed.sharding import (
    NamedSharding, P, ShardingRules, logical_to_spec)
from repro_torch.engine.mesh import all_gather, all_reduce, mesh_shape
from repro_torch.obs.compiled import program
from repro_torch.optim import AdamW, OptState

__all__ = [
    "make_train_step", "make_prefill_step", "make_decode_step",
    "train_shardings", "prefill_shardings", "decode_shardings",
    "named", "fitted", "batch_axes_tree", "ShardedTrainStep",
    "ShardedServeStep",
]


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and ``rest``, alike)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def named(mesh, spec_tree):
    """Spec tree -> ``NamedSharding`` tree."""
    return _tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def _fit_spec(spec: P, shape: tuple[int, ...], mesh) -> P:
    """Drop mesh axes that do not divide the corresponding dim (replicate
    fallback) — a block layout needs exact divisibility. E.g. kv_heads=4
    cannot split over model=16, so the K/V projections replicate over the
    model axis."""
    sizes = mesh_shape(mesh)
    out = []
    for i, entry in enumerate(spec):
        if entry is None or i >= len(shape):
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        kept: list[str] = []
        size = 1
        for a in axes:
            n = sizes[a]
            if shape[i] % (size * n) == 0:
                kept.append(a)
                size *= n
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return P(*out)


def _shape(x) -> tuple[int, ...]:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def fitted(mesh, spec_tree, shapes_tree):
    """Shape-aware ``NamedSharding`` tree (divisibility-safe); the shapes
    are tensors (``meta`` ones will do) or tuples."""
    return _tree_map(
        lambda s, sh: NamedSharding(mesh, _fit_spec(s, _shape(sh), mesh)),
        spec_tree, shapes_tree)


def batch_axes_tree(model, mode: str) -> dict:
    """Logical axes for the input batch dict of each mode."""
    cfg = model.cfg
    if mode in ("train", "prefill"):
        t = {"tokens": ("batch", "seq")}
        if cfg.kind == "encdec":
            t["frames"] = ("batch", "seq", None)
        if cfg.kind == "vlm":
            t["vision"] = ("batch", "seq", None)
        if mode == "train":
            t["labels"] = ("batch", "seq")
        return t
    return {"token": ("cache_batch", None)}


def _param_specs(model, rules, params_shapes) -> dict:
    """The model's parameter specs, in ``params_shapes``' order."""
    spec = logical_to_spec(rules, model.axes())
    return {n: spec[n] for n in params_shapes}


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def make_train_step(model, optimizer, n_microbatches: int = 1):
    """``train_step(opt_state, batch) -> (opt_state, metrics)`` on the
    model's parameters, which ``optimizer.update`` changes in place.

    ``batch`` is a dict of tensors on the model's device. With
    ``n_microbatches`` n > 1 the batch is cut into the reference's
    contiguous slices (``x.reshape((n, B // n) + ...)[i]``), each one's
    backward accumulates into the float32 ``.grad`` of the masters, and
    grads and loss are divided by n. Metrics: ``loss``, ``grad_norm`` and
    ``step``, 0-d tensors on the device (nothing is read back)."""
    params = dict(model.named_parameters())
    n = n_microbatches

    def train_step(opt_state, batch):
        for p in params.values():
            p.grad = None
        if n == 1:
            loss = model.loss(batch)
            loss.backward()
            loss = loss.detach()
        else:
            loss = torch.zeros((), device=next(iter(params.values())).device)
            for mb in _microbatches(batch, n):
                mb_loss = model.loss(mb)
                mb_loss.backward()
                loss = loss + mb_loss.detach()
            div = torch.tensor(float(n), device=loss.device)
            loss = loss / div
            for p in params.values():
                if p.grad is not None:
                    p.grad.div_(div)
        grads = {k: p.grad for k, p in params.items()}
        _, opt_state, gnorm = optimizer.update(grads, opt_state, params)
        for p in params.values():     # the grads' memory, free until the next
            p.grad = None
        return opt_state, {"loss": loss, "grad_norm": gnorm,
                           "step": opt_state.step.clone()}

    return train_step


def _microbatches(batch: dict, n: int):
    """The reference's contiguous microbatch slices of ``batch``."""
    for i in range(n):
        yield {k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
               for k, x in batch.items()}


def train_shardings(model, rules: ShardingRules, mesh, params_shapes,
                    opt_shapes: OptState, batch_shapes):
    """((params, opt state, batch), (params, opt state, metrics)) sharding
    trees of the train step; the opt state's as an ``OptState``."""
    p_spec = _param_specs(model, rules, params_shapes)
    p_sh = fitted(mesh, p_spec, params_shapes)
    opt_sh = OptState(step=NamedSharding(mesh, P()),
                      m=fitted(mesh, p_spec, opt_shapes.m),
                      v=fitted(mesh, p_spec, opt_shapes.v))
    b_spec = logical_to_spec(rules, batch_axes_tree(model, "train"))
    b_sh = fitted(mesh, b_spec, batch_shapes)
    metrics_sh = named(mesh, {"loss": P(), "grad_norm": P(), "step": P()})
    return (p_sh, opt_sh, b_sh), (p_sh, opt_sh, metrics_sh)


# Flat gradient slots start on 512-byte boundaries, the caching allocator's
# alignment: a reduction over a view then runs as over a tensor of its own
# (the card's reduce kernels vectorise by the pointer's alignment), so the
# meshed step's grad norm is the one-card step's, bit for bit.
_ALIGN = 128


class ShardedTrainStep:
    """The train step over a ``("data", "model")`` ``GridMesh``.

    Between steps each rank holds exactly its shards of the float32
    masters and of both AdamW moments, the blocks that the fitted specs of
    ``model.axes()`` give its mesh position (``shards``, ``OptState`` of
    shard dicts), and the model's parameters are empty. A step:

    1. gathers the parameters: one all-gather of the rank's shards, flat,
       from which the rank assembles only the slices it computes with
       (``tensor_parallel.plan``; whole parameters where nothing splits);
    2. runs the model's forward and backward on the rank's own ``"data"``
       rows of the global batch (``batch``: those rows; the reference's
       ``"batch"`` constraints) in contiguous slices, split over
       ``"model"`` as the reference's rules split it: each ``"model"``
       rank computes with its heads, ``d_ff`` columns, experts and vocab
       rows wherever the fitted specs split them (the flash and SSD
       kernels on its heads), with the layers' all-reduces over
       ``"model"`` between. ``n_microbatches`` counts the global batch's
       slices, as the reference's does: a multiple of ``"data"``, each
       rank taking ``n_microbatches // data`` of them (one each when it is
       smaller);
    3. writes the gradients into one flat float32 buffer of the whole
       gradients, the loss in its last slot, and sums that buffer over the
       whole mesh (one all-reduce; on a ``"model"`` of 1, under gloo, a
       left fold in rank order); divides it by the global microbatch
       count;
    4. takes the grad norm over the whole gradients in the one-card order
       and updates only the rank's shards with the elementwise AdamW.

    The gradient rule (``tensor_parallel.plan``'s modes): a rank writes a
    *disjoint* gradient (its own heads, columns, experts or vocab rows)
    and a *partial* one (kv heads that several ranks' q heads share,
    Mamba's B and C columns: each rank holds part of the sum) at its
    slice, and an *identical* one (a parameter used whole outside every
    split region: norms, the router, every product whose axis does not
    divide) only from ``"model"`` rank 0, which alone writes the loss; the
    all-reduce then sums each gradient exactly once. So a step issues one
    all-gather and one all-reduce of its own, recorded under ``KEY``, plus
    the split's all-reduces over ``"model"``. With a ``"model"`` of 1
    nothing splits and the ranks' sum is the one-card step's left fold
    of its microbatches: a step is the one-card step with the same
    microbatches bit for bit (the divisions are by powers of two). On a
    wider ``"model"`` the split reorders partial sums, as the reference's
    GSPMD step does against its single-device step.

    ``shard`` cuts this rank's shards from whole tensors (the seeded init
    or a restored checkpoint; ``release`` then empties the model's
    parameters); ``gather_state`` is the inverse, for a checkpoint (one
    all-gather a tensor under ``CKPT_KEY``, whole tensors on the host).
    ``logits`` runs the split forward alone, for a check.
    """

    KEY = "train.step:sharded"
    CKPT_KEY = "train.ckpt:sharded"
    LOGITS_KEY = "train.logits:sharded"

    def __init__(self, model, optimizer: AdamW, mesh,
                 n_microbatches: int = 1):
        self.model, self.opt, self.mesh = model, optimizer, mesh
        data = mesh.data_shards
        if n_microbatches > data and n_microbatches % data:
            raise ValueError(f"{n_microbatches} microbatches do not split "
                             f"over {data} data ranks")
        self.n = max(1, n_microbatches // data)      # this rank's
        self.div = float(self.n * data)              # the global count
        self.params = dict(model.named_parameters())
        self.shapes = {n: tuple(p.shape) for n, p in self.params.items()}
        self.device = next(iter(self.params.values())).device
        self.shardings = fitted(mesh, _param_specs(
            model, ShardingRules.create(mesh), self.shapes), self.shapes)
        coords = [mesh.position(r) for r in range(mesh.n_shards)]
        here = mesh.position()
        self.blocks = {n: s.block(self.shapes[n], here)
                       for n, s in self.shardings.items()}
        self.shard_shapes = {n: s.shard_shape(self.shapes[n])
                             for n, s in self.shardings.items()}
        # Per parameter, the ranks whose blocks tile it (one position for
        # each combination of the axes its spec uses) and their blocks.
        self.tiles = {}
        for n, s in self.shardings.items():
            used = {a for e in s.spec if e is not None
                    for a in ((e,) if isinstance(e, str) else e)}
            self.tiles[n] = [(r, s.block(self.shapes[n], c))
                             for r, c in enumerate(coords)
                             if all(c[a] == 0 for a in c if a not in used)]
        self.plan = tp.plan(model, {n: s.spec for n, s in
                                    self.shardings.items()}, mesh)
        self.compute_shapes = {n: self.plan.shape(n) for n in self.shapes}
        lead = mesh.model_rank == 0
        # How each gradient reaches the flat buffer: accumulated in place
        # into its whole slot ("view"), copied into its slice after the
        # backward ("slice"), or computed and dropped (an identical one
        # off "model" rank 0).
        self.route = {}
        for n, shape in self.shapes.items():
            if self.plan.modes[n] == "identical" and not lead:
                self.route[n] = "drop"
            elif self.compute_shapes[n] == shape:
                self.route[n] = "view"
            else:
                self.route[n] = "slice"
        self.grad_at, at = {}, 0
        for n, shape in self.shapes.items():
            self.grad_at[n] = at
            at += -(-math.prod(shape) // _ALIGN) * _ALIGN
        self.grad_size = at + 1          # the loss rides in the last slot

    # -- state ----------------------------------------------------------------

    @torch.no_grad()
    def shard(self, full: dict) -> dict:
        """This rank's shards (contiguous copies on the model's device) of
        whole tensors ``full`` (name -> tensor, any device)."""
        return {n: full[n][self.blocks[n]].to(self.device, copy=True)
                .contiguous() for n in self.shapes}

    def release(self) -> None:
        """Empty the model's parameters (and drop their grads)."""
        for p in self.params.values():
            p.grad = None
            p.data = torch.empty(0, dtype=p.dtype, device=self.device)

    def shard_bytes(self) -> int:
        """Bytes of one copy of this rank's shards."""
        return sum(math.prod(s) for s in self.shard_shapes.values()) * 4

    def compute_bytes(self) -> int:
        """Bytes of the parameters this rank holds during a step: the
        slices it computes with (float32)."""
        return sum(math.prod(s) for s in self.compute_shapes.values()) * 4

    def _assemble(self, n: str, got: torch.Tensor, at: int, device,
                  runs=None):
        """Parameter ``n``, or its slice given by ``runs`` (per dim, index
        runs), on ``device``, from the all-gathered shards ``got`` (rank,
        flat), its own starting at ``at``: each tile's overlap with the
        slice is copied once."""
        if runs is None:
            runs = tuple(((0, w),) for w in self.shapes[n])
        t = torch.empty(tuple(sum(b - a for a, b in d) for d in runs),
                        dtype=torch.float32, device=device)
        size = math.prod(self.shard_shapes[n])
        for r, blk in self.tiles[n]:
            pieces = [_overlaps(d, b.start, b.stop) for d, b in zip(runs, blk)]
            src = got[r, at:at + size].view(self.shard_shapes[n])
            for combo in itertools.product(*pieces):
                t[tuple(c[1] for c in combo)] = src[tuple(c[0] for c in combo)]
        return t

    @torch.no_grad()
    def _gather(self, shards: dict) -> dict:
        """The parameters this rank computes with on the model's device,
        from every rank's ``shards`` (this rank's given): one all-gather
        of them all, flat."""
        flat = torch.cat([shards[n].reshape(-1) for n in self.shapes])
        got = all_gather(self.mesh, flat).to(self.device)
        del flat
        mine, at = {}, 0
        for n in self.shapes:
            mine[n] = self._assemble(n, got, at, self.device,
                                     self.plan.runs[n])
            at += math.prod(self.shard_shapes[n])
        return mine

    @torch.no_grad()
    def gather_state(self, shards: dict, opt_state: OptState,
                     keep: bool = True):
        """(whole parameters, whole ``OptState``) on the host, from every
        rank's shards of the masters and moments, for a checkpoint; None on
        a rank that passes ``keep=False``. Every rank calls it. One
        all-gather a tensor (``3 x`` the parameter count, under
        ``CKPT_KEY``), each assembled where the gather left it and copied
        to the host: a save adds at most two whole tensors to the card's
        memory (the gathered shards and their assembly), not the state."""
        out = [{}, {}, {}]
        with program(self.CKPT_KEY):
            for d, part in zip(out, (shards, opt_state.m, opt_state.v)):
                for n in self.shapes:
                    got = all_gather(self.mesh, part[n].reshape(-1))
                    if keep:
                        d[n] = self._assemble(n, got, 0, got.device).cpu()
                    del got
        if not keep:
            return None
        p, m, v = out
        return p, OptState(step=opt_state.step.to("cpu", copy=True), m=m,
                           v=v)

    # -- the step ---------------------------------------------------------------

    def __call__(self, shards: dict, opt_state: OptState, batch: dict):
        """One step from this rank's ``shards`` and ``opt_state`` (updated
        in place) on its ``batch`` rows -> (opt_state, metrics), metrics as
        ``make_train_step``'s."""
        with program(self.KEY):
            mine = self._gather(shards)
            grads = torch.zeros(self.grad_size, device=self.device)
            views = {}
            for n, p in self.params.items():
                p.data = mine[n]
                views[n] = grads[self.grad_at[n]:self.grad_at[n]
                                 + math.prod(self.shapes[n])] \
                    .view(self.shapes[n])
                p.grad = views[n] if self.route[n] == "view" else None
            del mine
            loss = torch.zeros((), device=self.device)
            with tp.applied(self.model, self.plan.splits), \
                    _replay_whole(self.plan.splits):
                for mb in _microbatches(batch, self.n):
                    mb_loss = self.model.loss(mb)
                    mb_loss.backward()
                    loss = loss + mb_loss.detach()
            with torch.no_grad():
                for n, p in self.params.items():
                    if self.route[n] == "slice" and p.grad is not None:
                        _scatter(views[n], p.grad, self.plan.runs[n])
            self.release()
            if self.mesh.model_rank == 0:
                grads[-1] = loss
            all_reduce(self.mesh, grads, ("data", "model"),
                       ordered=self.mesh.model_shards == 1)
            grads.div_(torch.tensor(self.div, device=self.device))
            gnorm = self.opt.global_norm(views)
            self.opt.update({n: views[n][self.blocks[n]] for n in views},
                            opt_state, shards, gnorm=gnorm)
            loss = grads[-1].clone()
        return opt_state, {"loss": loss, "grad_norm": gnorm,
                           "step": opt_state.step.clone()}

    @torch.no_grad()
    def logits(self, shards: dict, batch: dict):
        """The split forward alone on this rank's ``batch`` rows -> their
        logits over the whole vocab (gathered over ``"model"``: a check's,
        never the step's), under ``LOGITS_KEY``."""
        with program(self.LOGITS_KEY):
            for n, t in self._gather(shards).items():
                self.params[n].data = t
            try:
                with tp.applied(self.model, self.plan.splits):
                    out = self.model(batch)[0]
            finally:
                self.release()
            vocab = self.plan.splits.get("")
            if vocab is not None:
                out = tp.gather_from_model(out, self.mesh, -1)
        return out


def _replay_whole(splits):
    """Under a split, a rematerialised block replays its whole forward in
    the backward (torch's early stop would skip its last all-reduce or not
    depending on what the block saved): every rank issues the same,
    countable all-reduces. Without one, torch's default."""
    if not splits:
        return contextlib.nullcontext()
    from torch.utils import checkpoint
    return checkpoint.set_checkpoint_early_stop(False)


def _overlaps(runs, a: int, b: int) -> list[tuple[slice, slice]]:
    """Where the index runs ``runs`` (in order) meet the block ``[a, b)``
    of one dim: (slice of the block, slice of the runs' concatenation)."""
    out, at = [], 0
    for s, e in runs:
        lo, hi = max(s, a), min(e, b)
        if lo < hi:
            out.append((slice(lo - a, hi - a), slice(at + lo - s, at + hi - s)))
        at += e - s
    return out


def _scatter(whole: torch.Tensor, part: torch.Tensor, runs) -> None:
    """Copy ``part`` (the concatenation of ``runs`` per dim) into its
    places in ``whole``."""
    pieces = [_overlaps(d, 0, w) for d, w in zip(runs, whole.shape)]
    for combo in itertools.product(*pieces):
        whole[tuple(c[0] for c in combo)] = part[tuple(c[1] for c in combo)]


# ---------------------------------------------------------------------------
# serve: prefill + decode
# ---------------------------------------------------------------------------

def _applied(model, splits):
    """``tensor_parallel.applied`` where something splits."""
    return tp.applied(model, splits) if splits else contextlib.nullcontext()


def _greedy(logits, split=None):
    """The greedy next token of the last position, (B, 1) int32: the first
    maximum, as ``argmax`` takes it. Over vocab-parallel logits (``split``:
    the model's vocab split) each rank holds its vocab columns: the
    maximum is ``max_over_model`` of the ranks' maxima, and the index of
    its first occurrence the least over the ranks of each one's first
    index of it (the vocab's size where a rank has none; a max of the
    negated indices), so ties break as on one device and the whole logits
    are never gathered."""
    last = logits[:, -1, :]
    if split is None:
        return last.argmax(dim=-1, keepdim=True).to(torch.int32)
    top = tp.max_over_model(last.max(dim=-1, keepdim=True).values,
                            split.mesh)
    hit = last == top
    first = hit.to(torch.uint8).argmax(dim=-1, keepdim=True) + split.lo
    idx = torch.where(hit.any(dim=-1, keepdim=True), first,
                      split.size * (split.hi - split.lo))
    return (-tp.max_over_model(-idx, split.mesh)).to(torch.int32)


def make_prefill_step(model, max_len: int | None = None, plan=None):
    """(batch) -> (next_token (B, 1) int32, cache). With ``plan`` (this
    ``"model"`` rank's ``tensor_parallel.Plan``, the model holding its
    slices) the step is split over ``"model"`` as the reference's meshed
    prefill: the rank's heads, ``d_ff`` columns, experts and vocab
    columns, a cache of its kv or SSD heads, greedy over the split logits;
    without one (or with no split in it) the one-card step."""
    splits = {} if plan is None else plan.splits

    def prefill_step(batch):
        with _applied(model, splits):
            logits, cache = model.prefill(batch, max_len=max_len)
            return _greedy(logits, splits.get("")), cache

    return prefill_step


def prefill_shardings(model, rules: ShardingRules, mesh, params_shapes,
                      batch_shapes, cache_shapes):
    p_spec = _param_specs(model, rules, params_shapes)
    b_spec = logical_to_spec(rules, batch_axes_tree(model, "prefill"))
    cache_spec = logical_to_spec(rules, model.cache_axes())
    B = _shape(batch_shapes["tokens"])[0]
    tok = fitted(mesh, rules.spec("cache_batch", None), (B, 1))
    in_s = (fitted(mesh, p_spec, params_shapes),
            fitted(mesh, b_spec, batch_shapes))
    out_s = (tok, fitted(mesh, cache_spec, cache_shapes))
    return in_s, out_s


def make_decode_step(model, plan=None):
    """One-token greedy serve step: (cache, token, pos) -> (next_token,
    cache); split over ``"model"`` with a rank's ``plan`` as
    ``make_prefill_step``, against that rank's cache."""
    splits = {} if plan is None else plan.splits

    def decode_step(cache, token, pos: int):
        with _applied(model, splits):
            logits, cache = model.decode(cache, token, pos)
            return _greedy(logits, splits.get("")), cache

    return decode_step


def decode_shardings(model, rules: ShardingRules, mesh, params_shapes,
                     cache_shapes, token_shape):
    p_spec = _param_specs(model, rules, params_shapes)
    cache_spec = logical_to_spec(rules, model.cache_axes())
    tok = fitted(mesh, rules.spec("cache_batch", None), token_shape)
    pos = NamedSharding(mesh, P())
    p_sh = fitted(mesh, p_spec, params_shapes)
    c_sh = fitted(mesh, cache_spec, cache_shapes)
    in_s = (p_sh, c_sh, tok, pos)
    out_s = (tok, c_sh)
    return in_s, out_s


class ShardedServeStep:
    """The reference's meshed serve steps (its ``make_prefill_step`` and
    ``make_decode_step`` run under ``prefill_shardings`` and
    ``decode_shardings``) on one rank of a ``("data", "model")`` mesh: a
    ``GridMesh`` of live ranks or a ``StandInMesh``.

    ``plan`` is the rank's split (``tensor_parallel.plan`` of the fitted
    parameter specs, as ``ShardedTrainStep``'s): its q and kv heads (with
    ``kv_index``), ``d_ff`` columns, experts, SSD heads and vocab rows,
    where the specs split them over ``"model"``. ``load`` puts the rank's
    slices of whole parameters into the model, which then holds nothing
    else; ``prefill`` and ``decode`` run the split steps on the rank's
    ``"data"`` rows of the batch (the caller's), each under its program
    key, and the rank's cache holds only its kv heads, or its SSD heads'
    state and its conv channels (its x channels with the whole B and C):
    the same bytes a rank of the fitted cache specs holds for the kv cache,
    whose reference layout splits the sequence instead. Greedy sampling
    takes the first maximum over the split logits (``_greedy``). A
    ``"model"`` of 1 splits nothing: the one-card steps, bit for bit.
    """

    PREFILL_KEY = "serve.prefill:sharded"
    DECODE_KEY = "serve.decode:sharded"

    def __init__(self, model, mesh, max_len: int | None = None):
        self.model, self.mesh = model, mesh
        shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
        specs = fitted(mesh, _param_specs(
            model, ShardingRules.create(mesh), shapes), shapes)
        self.plan = tp.plan(model, {n: s.spec for n, s in specs.items()},
                            mesh)
        self._prefill = make_prefill_step(model, max_len, self.plan)
        self._decode = make_decode_step(model, self.plan)

    @torch.no_grad()
    def load(self, whole: dict, device) -> None:
        """The rank's float32 slices of the whole parameters ``whole``
        (name -> tensor, any device) on ``device``, as the model's
        parameters (copies: ``whole`` may be freed; a model built on
        ``meta`` takes them too)."""
        for n, p in list(self.model.named_parameters()):
            part = self.plan.take(n, whole[n])
            mod, _, leaf = n.rpartition(".")
            self.model.get_submodule(mod)._parameters[leaf] = \
                torch.nn.Parameter(torch.empty(
                    part.shape, dtype=torch.float32, device=device)
                    .copy_(part), requires_grad=p.requires_grad)

    def param_bytes(self) -> int:
        """Bytes of the parameters the rank holds."""
        return sum(p.numel() * p.element_size()
                   for p in self.model.parameters())

    def init_cache(self, *args):
        """The rank's zero cache (``model.init_cache``'s arguments)."""
        with tp.applied(self.model, self.plan.splits):
            return self.model.init_cache(*args)

    def prefill(self, batch: dict):
        """(next token (B, 1) int32, the rank's cache) of the rank's rows."""
        with program(self.PREFILL_KEY):
            return self._prefill(batch)

    def decode(self, cache: dict, token, pos: int):
        """One greedy decode step of the rank's rows against its cache."""
        with program(self.DECODE_KEY):
            return self._decode(cache, token, pos)
