"""Inverse rendering: recover density / temperature grids from target images.

Port of volume_path_tracer_tpu/diff/inverse.py on one device. The loss
renders a pixel batch `samples_per_step` times through the path-replay
renderer (diff/prb.py trace_rays_prb: on the card the record kernel forward
and the replay kernel backward), its ray batch made by render/megakernel.py
loss_rays (on the card one launch that waits for nothing), and compares
the per-pixel mean with the target; the train step divides the gradient by
the loss's count and hands it to torch.optim.Adam, the update optax.adam
makes (its rounding order differs). On the card, once Adam has its state,
the step's launches run as one CUDA graph (StepGraph): the host replays
them with one call instead of issuing each. Checkpoints keep the JAX
package's file layout, so a checkpoint crosses packages in both directions.
With a mesh (parallel/shard.py) each cell takes a rays shard and an 'spp'
wave, and the gradients and the loss are summed over every cell before the
update.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..grids.grid import pack_corner_rows
from ..grids.majorant import build_majorants
from ..models.camera import Camera
from ..models.medium import Medium, pack_fused_rows
from ..parallel.shard import Mesh, to_device, tree_sum
from ..render.integrator import IntegratorParams, trace_rays_diff
from ..render.megakernel import kept_constants, loss_rays
from ..utils.spans import span
from .prb import trace_rays_prb


class OptimizableGrids(NamedTuple):
    """The optimized leaves. Density = softplus(log_density) keeps it >= 0."""

    log_density: torch.Tensor  # [X, Y, Z]
    temperature: Optional[torch.Tensor] = None  # the raw adimensional grid, or None


def grid_leaves(grids: OptimizableGrids):
    """The grids' tensors in the JAX package's leaf order (None left out)."""
    return [x for x in grids if x is not None]


def make_optimizer(grids: OptimizableGrids, lr: float = 1e-2) -> torch.optim.Adam:
    """torch.optim.Adam over the grids' tensors, with optax.adam's defaults
    (b1 0.9, b2 0.999, eps 1e-8). On CUDA leaves it is capturable (its step
    count on the card, so that a CUDA graph can hold the update: StepGraph),
    foreach as on the CPU."""
    leaves = grid_leaves(grids)
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            capturable=all(p.is_cuda for p in leaves))


def save_train_checkpoint(path, grids: OptimizableGrids, opt_state: torch.optim.Adam, step: int) -> None:
    """Write (grids, optimizer state, step) at a step boundary, in the JAX
    package's layout: `step`, `n_leaves` and `leaf_i` in optax's leaf order
    (the grids, then Adam's count, first moments, second moments). A fresh
    optimizer writes count 0 and zero moments, as optax.adam's init."""
    leaves = grid_leaves(grids)
    states = [opt_state.state.get(p, {}) for p in leaves]
    count = int(states[0]["step"]) if states and "step" in states[0] else 0
    mu = [s["exp_avg"] if "exp_avg" in s else torch.zeros_like(p) for s, p in zip(states, leaves)]
    nu = [s["exp_avg_sq"] if "exp_avg_sq" in s else torch.zeros_like(p) for s, p in zip(states, leaves)]
    arrays = [p.detach().cpu().numpy() for p in leaves] + [np.asarray(count, dtype=np.int32)]
    arrays += [m.detach().cpu().numpy() for m in mu] + [v.detach().cpu().numpy() for v in nu]
    payload = {f"leaf_{i}": a for i, a in enumerate(arrays)}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, step=step, n_leaves=len(arrays), **payload)
    os.replace(tmp, path)


def load_train_checkpoint(path, grids_like: OptimizableGrids, opt_state_like: torch.optim.Adam):
    """Returns (grids, optimizer, step), or None when the file is absent or
    its leaves do not fit the templates. The grids' tensors are written in
    place and the optimizer's state set, so `opt_state_like` keeps working
    on the same tensors; a capturable optimizer gets its step count on the
    leaf's device, as it keeps it."""
    if not os.path.exists(path):
        return None
    z = np.load(path)
    leaves = grid_leaves(grids_like)
    m = len(leaves)
    if int(z["n_leaves"]) != 3 * m + 1:
        return None
    arrays = [z[f"leaf_{i}"] for i in range(3 * m + 1)]
    shapes = [tuple(p.shape) for p in leaves]
    if [a.shape for a in arrays[:m]] != shapes or arrays[m].shape != () or \
            [a.shape for a in arrays[m + 1:]] != shapes * 2:
        return None
    count = int(arrays[m])
    capturable = any(g.get("capturable", False) for g in opt_state_like.param_groups)
    with torch.no_grad():
        for p, a in zip(leaves, arrays[:m]):
            p.copy_(torch.from_numpy(np.asarray(a, dtype=np.float32)))
    for i, p in enumerate(leaves):
        opt_state_like.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32, device=p.device if capturable else None),
            "exp_avg": torch.from_numpy(np.asarray(arrays[m + 1 + i], dtype=np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.asarray(arrays[2 * m + 1 + i], dtype=np.float32)).to(p.device),
        }
    return grids_like, opt_state_like, int(z["step"])


def density_from_param(p: torch.Tensor) -> torch.Tensor:
    """softplus(p) as jax.nn.softplus computes it, log(1 + e^p) at every p
    (torch's F.softplus returns p itself above its threshold of 20)."""
    return torch.logaddexp(p, torch.zeros((), dtype=p.dtype, device=p.device))


def param_from_density(d: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    """The inverse of density_from_param, with the density floored at eps."""
    d = torch.clamp(d, min=eps)
    return d + torch.log(-torch.expm1(-d))


def medium_with_params(base: Medium, grids: OptimizableGrids, bloat: float = 0.1, pack: bool = False) -> Medium:
    """The medium of the optimized leaves, rebuilt every step.

    Majorants come from the detached density with `bloat` slack (gradient
    rendering needs a null-collision probability > 0 everywhere;
    grids/majorant.build_majorants). pack=True builds the fused rows (8
    wide) and the temperature corner rows too, from detached data: the
    replay gradient never differentiates through them. pack=False makes no
    copy: the dense kernels read the leaves' arrays themselves (the
    temperature leaf, and softplus of the log-density).
    """
    density = dataclasses.replace(base.density, data=density_from_param(grids.log_density))
    temperature = base.temperature
    if grids.temperature is not None and base.temperature is not None:
        temperature = dataclasses.replace(base.temperature, data=grids.temperature)
    majorants = build_majorants(density, bloat=bloat)
    return Medium(
        density=density,
        majorants=majorants,
        temperature=temperature,
        density_rows=pack_fused_rows(density.data.detach(), majorants) if pack else None,
        temperature_rows=(pack_corner_rows(temperature.data.detach())
                          if (pack and temperature is not None) else None),
    )


def make_render_loss(
    base_medium: Medium,
    params: IntegratorParams,
    camera: Camera,
    bb_table,
    n_iters: int,
    use_jitter: bool,
    samples_per_step: int = 4,
    use_prb: bool = True,
    pack: bool = False,
    dual_buffer: bool = False,
):
    """loss(grids, raster, pids, target_px, seed_wave) -> (sum_sq, n).

    Renders `samples_per_step` = k independent waves of the pixel batch as
    one flat ray batch (waves seed_wave[1] * k + i of seed seed_wave[0]) and
    compares the per-pixel mean with the target: averaging k samples cuts
    the Monte Carlo noise floor of the loss k-fold. dual_buffer=True (k >=
    2) splits the samples into halves A and B and uses sum((A - t) * (B -
    t)), whose expectation is the squared error of the mean without the
    variance term, so its gradient is unbiased (the variance term's gradient
    pulls toward low-variance parameters, visibly for blackbody emission).

    use_prb=True differentiates through the path replay (trace_rays_prb,
    truncating at n_iters, and pack=True may use the fused rows);
    use_prb=False through the autograd oracle (integrator.trace_rays_diff).
    Returns the batch's sum and count (n = pixels * 3, a float).
    target_px: [N, 3] target film XYZ (imaging_ratio-scaled means).
    """
    k = samples_per_step
    if dual_buffer and k < 2:
        raise ValueError("dual_buffer needs samples_per_step >= 2")
    if use_prb:
        # The replay truncates at params.max_iters; mirror the loop's bound.
        params = dataclasses.replace(params, max_iters=n_iters)

    def loss_fn(grids: OptimizableGrids, raster, pids, target_px, seed_wave):
        with span("train.rebuild"):
            medium = medium_with_params(base_medium, grids, pack=pack and use_prb)
        n = pids.shape[0]
        with span("train.rays"):
            o_w, d_w, pids_k, stream_k = loss_rays(camera, raster, pids, seed_wave, k, use_jitter)
        if use_prb:
            L = trace_rays_prb(medium, params, bb_table, o_w, d_w, pids_k, stream_k)
        else:
            L = trace_rays_diff(medium, params, bb_table, o_w, d_w, pids_k, stream_k, n_iters)
        Lk = camera.imaging_ratio * L.reshape(k, n, 3)
        if dual_buffer:
            a = Lk[: k // 2].mean(dim=0) - target_px
            b = Lk[k // 2:].mean(dim=0) - target_px
            sq = (a * b).sum()
        else:
            sq = ((Lk.mean(dim=0) - target_px) ** 2).sum()
        return sq, float(n * 3)

    return loss_fn


def make_train_step(
    base_medium: Medium,
    params: IntegratorParams,
    camera: Camera,
    bb_table,
    n_iters: int = 512,
    use_jitter: bool = True,
    mesh: Optional[Mesh] = None,
    samples_per_step: int = 4,
    use_prb: bool = True,
    pack: bool = False,
    dual_buffer: bool = False,
):
    """step(grids, opt, raster, pids, target_px, seed_wave) -> (grids, opt,
    loss): the loss's gradient over its count into torch.optim.Adam (`opt`,
    from make_optimizer over `grids`' tensors, which are updated in place).
    `loss` is a 0-d tensor; nothing waits for the device. dual_buffer: see
    make_render_loss.

    Without a mesh, with the path replay on unpacked media (use_prb,
    pack=False), the step holds a StepGraph (`step.graph`; None otherwise):
    on CUDA leaves with a capturable Adam that has its state (every step
    after the first), the same body runs as one CUDA graph, captured at the
    first such call and replayed after; such a step leaves the leaves'
    .grad None. Every other call runs the body eagerly.

    With a mesh (the counterpart of the JAX package's shard_map step) the
    batch's N rows split into R contiguous shards (N a multiple of R); cell
    (r, s) takes shard r at seed-wave (seed, wave * S + s) on its device,
    and its own backward (of its squared error over n) gives its gradients
    on the grids' device. The gradients and the squared error are summed
    over this process's cells (shard.tree_sum), then across processes
    (torch.distributed.all_reduce), before the update: loss = sum / n and
    gradient = the sum's gradient / n, n the count over every cell.
    """
    make_loss = functools.partial(
        make_render_loss, params=params, n_iters=n_iters, use_jitter=use_jitter,
        samples_per_step=samples_per_step, use_prb=use_prb, pack=pack, dual_buffer=dual_buffer,
    )
    if mesh is not None:
        return _sharded_train_step(mesh, base_medium, camera, bb_table, make_loss)
    loss_fn = make_loss(base_medium, camera=camera, bb_table=bb_table)

    def body(grids: OptimizableGrids, opt: torch.optim.Adam, raster, pids, target_px, seed_wave):
        with span("train.optimizer"):
            opt.zero_grad(set_to_none=True)
        sq, n = loss_fn(grids, raster, pids, target_px, seed_wave)
        with span("train.backward"):
            (sq / n).backward()
        leaves = grid_leaves(grids)
        _update(opt, leaves, [p.grad for p in leaves])
        return sq, n

    graph = StepGraph(body) if use_prb and not pack else None

    def train_step(grids: OptimizableGrids, opt: torch.optim.Adam, raster, pids, target_px, seed_wave):
        with span("train.step"):
            if graph is not None and graph.applies(grids, opt, raster, pids, target_px):
                sq, n = graph(grids, opt, raster, pids, target_px, seed_wave)
            else:
                sq, n = body(grids, opt, raster, pids, target_px, seed_wave)
            return grids, opt, sq.detach() / n

    train_step.graph = graph
    return train_step


_LIVE = weakref.WeakSet()  # the StepGraphs that hold a graph: the pools they share


def _fingerprint(x):
    """What a captured graph baked in of a tensor (its memory) or a value."""
    if isinstance(x, torch.Tensor):
        return (x.data_ptr(), tuple(x.shape), x.stride(), x.dtype)
    return x


class StepGraph:
    """One train step's body as a CUDA graph on one device.

    The body (zero_grad, the loss, its backward, the update) is captured as
    it runs eagerly, every kernel in its own hand-written or torch form, and
    replayed by one launch. A graph bakes in memory and values, so it is
    replayed only while what it read is unchanged: the leaves, Adam's state
    tensors and hyperparameters, and the raster, pids and target tensors
    (the caller's own, read where they lie: a target changed in place is
    read as it is then); on any change it is captured again (`captures`
    counts them). The seed and wave reach loss_rays_kernel as two device
    words, written before each replay by a fill whose value travels in the
    launch: nothing is copied from the host and nothing waits for the card.

    The graphs of a device share one memory pool. That is safe in any call
    order because nothing a replay wrote inside the pool is read after it
    returns: the loss (kept alive by its graph) is divided by an eager op
    on the same stream, and the leaves, Adam's state, the inputs and the
    words live outside the pool. The gradients live in it, so a replayed
    step leaves the leaves' .grad None.
    """

    def __init__(self, body):
        self.body = body
        self.graph = self.key = self.device = None
        self.inputs = ()  # the raster, pids and target the graph reads (kept alive)
        self.words = None  # int64 [1]: as int32 [2], the seed and wave words
        self.stream = None  # the side stream the captures run on
        self.sq = self.n = None  # the captured loss's sum (in the pool) and its count
        self.kept = ()  # the kernel constants the captured launches point into
        self.captures = self.replays = 0

    @staticmethod
    def applies(grids: OptimizableGrids, opt: torch.optim.Adam, raster, pids, target_px) -> bool:
        """Whether this call can run as the graph: every tensor on one CUDA
        device, and a capturable Adam that has its state for every leaf."""
        leaves = grid_leaves(grids)
        dev = leaves[0].device
        return (dev.type == "cuda" and all(t.device == dev for t in (*leaves, raster, pids, target_px))
                and all(g.get("capturable", False) for g in opt.param_groups)
                and all(p in opt.state and "step" in opt.state[p] for p in leaves))

    @staticmethod
    def _key(grids: OptimizableGrids, opt: torch.optim.Adam, raster, pids, target_px):
        leaves = grid_leaves(grids)
        state = [_fingerprint(v) for p in leaves for _, v in sorted(opt.state[p].items())]
        hyper = [tuple((k, _fingerprint(v)) for k, v in sorted(g.items()) if k != "params")
                 for g in opt.param_groups]
        params = [_fingerprint(p) for g in opt.param_groups for p in g["params"]]
        inputs = [_fingerprint(x) for x in (raster, pids, target_px)]
        return tuple(map(tuple, ([_fingerprint(p) for p in leaves], state, hyper, params, inputs)))

    def __call__(self, grids: OptimizableGrids, opt: torch.optim.Adam, raster, pids, target_px, seed_wave):
        """The step as the graph: (the loss's sum, its count)."""
        key = self._key(grids, opt, raster, pids, target_px)
        if key != self.key:
            with span("train.capture"):
                self._capture(key, grids, opt, raster, pids, target_px)
        with span("train.replay"):
            seed, wave = int(seed_wave[0]) & 0xFFFFFFFF, int(seed_wave[1]) & 0xFFFFFFFF
            word = wave << 32 | seed  # little-endian: the int32 view reads (seed, wave)
            self.words.fill_(word - (word >> 63 << 64))
            self.graph.replay()
            self.replays += 1
        return self.sq, self.n

    def _capture(self, key, grids: OptimizableGrids, opt: torch.optim.Adam, raster, pids, target_px):
        dev = raster.device
        self.graph = self.key = self.sq = None  # the old graph's pool blocks go back first
        # A pool is shared through a live graph: one whose graphs all died
        # may not take a capture again.
        live = [g.graph for g in _LIVE if g.device == dev and g.graph is not None]
        pool = live[0].pool() if live else torch.cuda.graph_pool_handle()
        if self.words is None or self.words.device != dev:
            self.words = torch.zeros((1,), dtype=torch.int64, device=dev)
            self.stream = torch.cuda.Stream(dev)
        side, here = self.stream, torch.cuda.current_stream(dev)
        graph = torch.cuda.CUDAGraph()
        side.wait_stream(here)
        with torch.cuda.stream(side):
            graph.capture_begin(pool=pool)
            try:
                sq, n = self.body(grids, opt, raster, pids, target_px, self.words.view(torch.int32))
            finally:
                graph.capture_end()
        here.wait_stream(side)
        for p in grid_leaves(grids):
            p.grad = None  # its memory is the pool's: another graph may reuse it
        self.graph, self.key, self.device, self.sq, self.n = graph, key, dev, sq.detach(), n
        self.inputs = (raster, pids, target_px)
        self.kept = kept_constants()
        self.captures += 1
        _LIVE.add(self)


def _update(opt: torch.optim.Adam, leaves, grads):
    """The step's update: each leaf's gradient `grads` (None: it has none),
    then opt.step(). The gradients are already over the loss's count: the
    steps differentiate the loss's sum over its count, which scales the
    backward's seed and costs no pass of its own over the gradient grids."""
    with span("train.optimizer"):
        for p, g in zip(leaves, grads):
            # optax updates a leaf with no gradient as one with a zero gradient
            p.grad = torch.zeros_like(p) if g is None else g
        opt.step()


def _sharded_train_step(mesh: Mesh, base_medium: Medium, camera: Camera, bb_table, make_loss):
    R, S = mesh.shape["rays"], mesh.shape["spp"]
    losses = {}  # device -> the loss of a cell there, over the scene's copies on it

    def cell_loss(dev):
        key = str(dev)
        if key not in losses:
            losses[key] = make_loss(to_device(base_medium, dev), camera=to_device(camera, dev),
                                    bb_table=to_device(bb_table, dev))
        return losses[key]

    def train_step(grids: OptimizableGrids, opt: torch.optim.Adam, raster, pids, target_px, seed_wave):
        with span("train.step"):
            with span("train.optimizer"):
                opt.zero_grad(set_to_none=True)
            leaves = grid_leaves(grids)
            n_rays = pids.shape[0]
            if n_rays % R:
                raise ValueError(f"{n_rays} pixels do not split into {R} 'rays' shards (pad the batch)")
            per = n_rays // R
            n = float(per * 3 * mesh.size)
            seed, wave = int(seed_wave[0]), int(seed_wave[1])
            sqs, grads = [], []
            for r, s, dev in mesh.local_cells():
                rows = slice(r * per, (r + 1) * per)
                cell_grids = OptimizableGrids(*(None if x is None else x.to(dev) for x in grids))
                sq, _ = cell_loss(dev)(cell_grids, raster[rows].to(dev), pids[rows].to(dev),
                                       target_px[rows].to(dev), (seed, (wave * S + s) & 0xFFFFFFFF))
                with span("train.backward"):
                    g = torch.autograd.grad(sq / n, leaves, allow_unused=True)
                sqs.append(sq.detach().to(leaves[0].device))
                grads.append(g)
            sq = tree_sum(sqs)
            # A leaf has no gradient in every cell or in none: the graph is one.
            total = [None if col[0] is None else tree_sum(col) for col in zip(*grads)]
            if mesh.spans_processes:
                for t in (sq, *total):
                    if t is not None:
                        dist.all_reduce(t)
            _update(opt, leaves, total)
            return grids, opt, sq / n

    train_step.graph = None
    return train_step
