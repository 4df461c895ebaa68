"""Row-sharded rendering and training over a DeviceMesh
(`loltracer_tpu/parallel/sharded.py`).

The image's rows are split over every rank of the mesh (parallel/mesh.py),
as the JAX package splits them over every mesh axis with shard_map: all
dimensions, the major first, so that rank r of the mesh, in mesh order,
owns the rows perm[r * R:(r + 1) * R], R = H / n. The rows are dealt in
G-row blocks (`row_granularity`: 8 for compiled structures, a 16-row patch
row for instanced ones) by `assign_blocks`, snake without costs and the
capacity-constrained LPT deal over the cost model of
utils/profiling.block_row_costs with `balance_params`; a height that does
not split into n * G blocks gets contiguous bands. Pixel values do not
depend on the deal. On a mesh of one rank the deal is the identity
whatever the costs, so the cost model is not run there.

Forward: each rank renders its own rows and needs no communication; the
renderer all-gathers the row blocks over the mesh and undoes the deal, so
every rank returns the whole [H, W, 3]. The loss: each rank's sum of
squared errors over its rows, all-reduced (SUM), over H * W * 3. Its
gradient: the parameters enter each rank's render through one flat
buffer of the fields that require grad, in FIELDS order, whose backward
all-reduces the gradient (one SUM), so every rank gets the whole
gradient, bitwise the same; the train step's Adam and `project` then
leave every rank's params bitwise equal.

Two tiers per rank, as JAX's: the fused training kernels when `fused`
selects them and the estimator is "envelope" (K1r / K2 for compiled
structures, K5r / K6 for instanced ones, each launched over the rank's
rows with a row table, render/fused_train.py and instanced_train.py),
else the differentiable renderer (render/torch_renderer.py `render_rays`
on the rank's rows; instanced structures in checkpointed 16-row bands).
`fused`: "auto" takes the kernels when cfg.march_backend resolves to them
(CUDA tensors) and the differentiable renderer otherwise; "interpret"
takes the kernels' plain twins, which run on CPU tensors (the counterpart
of Pallas interpret mode); "off" the differentiable renderer. On CUDA
tensors a kernel that fails to build or launch raises: nothing falls back.

The train step as one CUDA graph (`graphed_step`): where the rank renders
through K1r / K2 (a compiled structure, envelope shadows, the fused tier)
on the card and the mesh has one rank, the step runs its first call with
given params and target eagerly, captures the loss and its backward on the
second and replays that graph on every later call, so the host launches
one graph in place of the forward's and backward's glue. The graph is
keyed on the address, shape, strides, dtype and requires_grad of every
params field and of the target: a call with other tensors runs eagerly
once and then captures anew. The optimizer's step and `project` stay
eager after the replay (their hooks fire once a step). Everything else
(instanced structures, whose step builds a cell grid on the host; the
differentiable renderer; CPU tensors; meshes of more than one rank) runs
every step eagerly. The counters `train_step.captures`, `.replays` and
`.eager` (utils/tracing.py) count the steps of each kind. K1r's and K2's
wrappers count the launches they make (render/fused_train.py): an eager
step's, not the capture's, which launches nothing; a replay launches the
captured kernels without them, so a device trace, not those counts, shows
each replay's K1r and K2.

Two things differ from an eager step for the caller. From the capture on,
each leaf's `.grad` is the graph's output, one tensor that every replay
overwrites: a caller who keeps a step's gradient clones it. And the last
graph captured on a device, with its memory pool (its forward's and
backward's tensors), stays alive after its train step is gone, until the
process ends or the next capture there takes the pool over
(`_last_graph`): 0.82 GB reserved in all after five scene4 fits at
1920x1080 on an H100 (chip_tests/test_train_graph_chip.py).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from loltracer_tpu_torch.config import DEFAULT_CONFIG, RenderConfig
from loltracer_tpu_torch.render.backend import resolve_device, resolve_march_backend
from loltracer_tpu_torch.render.camera import camera_rays_for_rows
from loltracer_tpu_torch.render.cuda_scene import PATCH_ROW_BLOCK, TRAIN_ROW_BLOCK
from loltracer_tpu_torch.render.torch_renderer import pixel_radius, render_rays
from loltracer_tpu_torch.render.vecmath import true_div
from loltracer_tpu_torch.scene import FIELDS, SceneParams, SceneStructure, params_to
from loltracer_tpu_torch.utils import tracing

# Rows of an instanced patch (`loltracer_tpu/render/pallas_march.py:148` P_H):
# the row-table block of the instanced training kernels (csrc/fused_fwd.cuh
# kPatchRowBlock), as TRAIN_ROW_BLOCK (8) is the compiled ones'.
P_H = PATCH_ROW_BLOCK

# the train steps of each kind, since the process started (module docstring)
graph_captures = 0
graph_replays = 0
eager_steps = 0

tracing.register_counters(
    "train_step", lambda: {"train_step.captures": graph_captures,
                           "train_step.replays": graph_replays,
                           "train_step.eager": eager_steps})


class _Shard(NamedTuple):
    """This rank's place in the mesh: the group over all its ranks, their
    number, this rank's position in mesh order, and the group rank of each
    mesh position (the order of an all-gather)."""

    group: Optional[dist.ProcessGroup]
    size: int
    index: int
    order: tuple


def _check_divisible(height: int, mesh: DeviceMesh) -> None:
    n = mesh.size()
    if height % n != 0:
        raise ValueError(
            f"image height {height} must divide evenly over {n} devices; "
            f"pad the render height (e.g. to {-(-height // n) * n})"
        )


def _row_axes(mesh: DeviceMesh) -> tuple:
    """Every mesh dimension, major to minor: rows shard over all of them."""
    return tuple(mesh.mesh_dim_names or ())


def _mesh_shard(mesh: DeviceMesh) -> _Shard:
    """This rank's _Shard. The mesh's ranks in mesh order are its
    dimensions' (_row_axes), major to minor. A 1-D mesh carries its
    dimension's group; a mesh of more dimensions must span the world,
    whose group it then uses."""
    if mesh.get_coordinate() is None:
        raise ValueError("this rank is not in the mesh")
    ranks = mesh.mesh.flatten().tolist()
    if len(ranks) == 1:
        return _Shard(None, 1, 0, (0,))
    if mesh.ndim == 1:
        group = mesh.get_group(0)
    elif sorted(ranks) == list(range(dist.get_world_size())):
        group = dist.group.WORLD
    else:
        raise ValueError(f"rows sharded over {_row_axes(mesh)}: a mesh of more than one "
                         "dimension must span the world's ranks")
    return _Shard(group, len(ranks), ranks.index(dist.get_rank()),
                  tuple(dist.get_group_rank(group, r) for r in ranks))


def row_granularity(structure: SceneStructure) -> int:
    """Deal and row-table block: whole 16-row patch rows for instanced
    structures, 8-row groups for compiled ones."""
    return P_H if structure.instanced else TRAIN_ROW_BLOCK


def assign_blocks(n_blocks: int, n_shards: int, block_costs=None) -> np.ndarray:
    """Owner shard per G-row block, each shard owning n_blocks / n_shards
    blocks. Without costs the snake deal (0..N-1, N-1..0, ...); with costs,
    capacity-constrained LPT: blocks in order of decreasing cost, each to
    the least-loaded shard with capacity left."""
    owner = np.empty(n_blocks, np.int64)
    if block_costs is None:
        for b in range(n_blocks):
            r = b % (2 * n_shards)
            owner[b] = r if r < n_shards else 2 * n_shards - 1 - r
        return owner
    costs = np.asarray(block_costs, np.float64)
    if costs.shape != (n_blocks,):
        raise ValueError(f"block_costs must have shape ({n_blocks},); got {costs.shape}")
    cap = n_blocks // n_shards
    load = np.zeros(n_shards)
    count = np.zeros(n_shards, np.int64)
    for b in np.argsort(-costs):
        open_shards = np.flatnonzero(count < cap)
        i = open_shards[np.argmin(load[open_shards])]
        owner[b] = i
        load[i] += costs[b]
        count[i] += 1
    return owner


def interleave_rows(height: int, n_shards: int, G: int, block_costs=None):
    """(perm, inv) int arrays of the dealt row order (perm[i] is the image
    row at sharded position i; each shard's blocks in image order), or
    None when the height does not split into n_shards * G blocks."""
    if height % (n_shards * G):
        return None
    nblocks = height // G
    owner = assign_blocks(nblocks, n_shards, block_costs)
    perm = np.concatenate([
        np.concatenate([np.arange(b * G, (b + 1) * G) for b in range(nblocks) if owner[b] == i])
        for i in range(n_shards)
    ])
    return perm, np.argsort(perm)


def _row_permutation(structure, height, width, n, cfg, interleave, balance_params):
    """(perm, inv) of the deal, or None (contiguous). With balance_params,
    per-block costs of the step-count model drive the LPT deal, when
    there is a deal to make (more than one rank, n * G rows dividing the
    height); else the snake deal."""
    if not interleave:
        return None
    G = row_granularity(structure)
    bc = None
    if balance_params is not None and n > 1 and height % (n * G) == 0:
        from loltracer_tpu_torch.utils.profiling import block_row_costs

        bc = block_row_costs(structure, balance_params, height, width, G, cfg)
    return interleave_rows(height, n, G, block_costs=bc)


def _fused_tier(cfg, fused, device) -> bool:
    """Whether a rank renders through the fused training tier (module
    docstring); cfg.march_backend resolved for `device`."""
    if fused == "off" or cfg.shadow_grad != "envelope":
        return False
    if fused == "auto":
        return cfg.march_backend == "pallas"
    if fused == "interpret":
        if device.type != "cpu":
            raise ValueError("fused='interpret' runs the kernels' plain twins on CPU tensors; "
                             "on the card 'auto' launches the kernels")
        return True
    raise ValueError(f"unknown fused mode {fused!r}")


def graphed_step(structure: SceneStructure, cfg: RenderConfig, fused: str, device, ranks: int
                 ) -> bool:
    """Whether make_sharded_train_step replays its forward and backward as
    one CUDA graph (module docstring): on a CUDA device, over a mesh of one
    rank, for a compiled structure through the fused tier (K1r / K2).
    cfg.march_backend resolved for `device`, as the step resolves it."""
    device = torch.device(device)
    return (device.type == "cuda" and ranks == 1 and not structure.instanced
            and _fused_tier(cfg, fused, device))


def _fused_row_renderer(structure, cfg, n, height, width, fused, device):
    """`(params, rows) -> [len(rows), W, 3]` through the fused training
    tier, or None for the differentiable renderer (module docstring). The
    row table is the rank's rows[::G]."""
    if not _fused_tier(cfg, fused, device):
        return None
    G = row_granularity(structure)
    if structure.instanced:
        from loltracer_tpu_torch.render.instanced_train import (
            make_instanced_training_renderer as make,
        )
    else:
        from loltracer_tpu_torch.render.fused_train import make_training_renderer as make
    tab_fn = make(structure, height // n, width, cfg, device=device, full_height=height,
                  with_row_table=True)

    def fn(params: SceneParams, rows: torch.Tensor) -> torch.Tensor:
        return tab_fn(params, rows[::G].to(torch.float32))

    return fn


def _jnp_row_renderer(structure, cfg, height, width, dtype, band_rows: int = 16):
    """`(params, rows) -> [len(rows), W, 3]` through the differentiable
    renderer: compiled structures in one call, instanced ones in bands of
    the largest count of rows <= band_rows that divides the shard's,
    each checkpointed under autograd (torch_renderer.render_image_banded's
    bands: one band's [rays, 512]-sphere temporaries alive at a time)."""

    def render_rows(params: SceneParams, rows: torch.Tensor) -> torch.Tensor:
        pr = pixel_radius(params, height, cfg) if cfg.antialias else None
        if not structure.instanced or rows.shape[0] <= band_rows:
            ro, rd = camera_rays_for_rows(params, rows, height, width, cfg, dtype)
            return render_rays(structure, params, ro, rd, cfg, pixel_rad=pr)
        n = rows.shape[0]
        bw = next(b for b in range(band_rows, 0, -1) if n % b == 0)
        scene = None
        if resolve_march_backend(cfg.march_backend, params.cam_point) == "pallas":
            from loltracer_tpu_torch.render.march_kernels import pack_march_scene

            scene = pack_march_scene(structure, params)

        def band(rs):
            ro, rd = camera_rays_for_rows(params, rs, height, width, cfg, dtype)
            return render_rays(structure, params, ro, rd, cfg, pixel_rad=pr, march_scene=scene)

        remat = torch.is_grad_enabled()
        return torch.cat([checkpoint(band, rs, use_reentrant=False, preserve_rng_state=False)
                          if remat else band(rs) for rs in rows.reshape(-1, bw)])

    return render_rows


class _AllReduceGrad(torch.autograd.Function):
    """Identity forward; the backward all-reduces (SUM) the gradient over
    the group: replicated parameters whose uses are sharded."""

    @staticmethod
    def forward(ctx, flat, group):
        ctx.group = group
        return flat.view_as(flat)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AllReduceSum(torch.autograd.Function):
    """The SUM over the group forward; the cotangent passes unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _replicated(params: SceneParams, shard: _Shard) -> SceneParams:
    """params whose fields that require grad pass through one flat buffer
    (FIELDS order) with an all-reduced gradient."""
    names = [f for f in FIELDS if getattr(params, f).requires_grad]
    if shard.size == 1 or not names:
        return params
    flat = _AllReduceGrad.apply(torch.cat([getattr(params, f).reshape(-1) for f in names]),
                                shard.group)
    parts = flat.split([getattr(params, f).numel() for f in names])
    return dataclasses.replace(
        params, **{f: t.view_as(getattr(params, f)) for f, t in zip(names, parts)})


class _Sharding(NamedTuple):
    """What a sharded function needs: the shard, the device, this rank's
    rows, the inverse of the deal (None: no deal), the row renderer, and
    the config with its march backend resolved."""

    shard: _Shard
    device: torch.device
    rows: torch.Tensor
    inv: Optional[torch.Tensor]
    render_rows: Callable
    cfg: RenderConfig


def _sharding(structure, mesh, height, width, cfg, dtype, fused, interleave, balance_params,
              device, who) -> _Sharding:
    _check_divisible(height, mesh)
    shard = _mesh_shard(mesh)
    device = resolve_device(device if device is not None else mesh.device_type, who)
    cfg = cfg.replace(
        march_backend=resolve_march_backend(cfg.march_backend, torch.empty(0, device=device)))
    fused_fn = _fused_row_renderer(structure, cfg, shard.size, height, width, fused, device)
    render_rows = fused_fn or _jnp_row_renderer(structure, cfg, height, width, dtype)
    if balance_params is not None:
        balance_params = params_to(balance_params, device=device, dtype=torch.float32)
    pi = _row_permutation(structure, height, width, shard.size, cfg, interleave,
                          balance_params)
    perm, inv = (np.arange(height), None) if pi is None else pi
    r = height // shard.size
    rows = torch.as_tensor(perm[shard.index * r:(shard.index + 1) * r], device=device)
    return _Sharding(shard, device, rows,
                     None if inv is None else torch.as_tensor(inv, device=device), render_rows,
                     cfg)


def make_sharded_renderer(
    structure: SceneStructure,
    mesh: DeviceMesh,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    dtype: torch.dtype = torch.float32,
    fused: str = "auto",
    interleave: bool = True,
    balance_params: Optional[SceneParams] = None,
    device=None,
) -> Callable[[SceneParams], torch.Tensor]:
    """`params -> [H, W, 3]` with the rows sharded over the mesh (module
    docstring); every rank of the mesh calls it with the same params and
    gets the whole image. Rendering only (no autograd): gradients go
    through make_sharded_loss. `device` defaults to the mesh's device
    type; params go there as float32."""
    sh = _sharding(structure, mesh, height, width, cfg, dtype, fused, interleave, balance_params,
                   device, "make_sharded_renderer")

    def renderer(params: SceneParams) -> torch.Tensor:
        params = params_to(params, device=sh.device, dtype=torch.float32)
        with torch.no_grad():
            img = sh.render_rows(params, sh.rows).contiguous()
            if sh.shard.size > 1:
                parts = [torch.empty_like(img) for _ in range(sh.shard.size)]
                dist.all_gather(parts, img, group=sh.shard.group)
                img = torch.cat([parts[g] for g in sh.shard.order])
            return img if sh.inv is None else img[sh.inv]

    return renderer


def make_sharded_loss(
    structure: SceneStructure,
    mesh: DeviceMesh,
    height: int,
    width: int,
    cfg: RenderConfig = DEFAULT_CONFIG,
    dtype: torch.dtype = torch.float32,
    fused: str = "auto",
    interleave: bool = True,
    balance_params: Optional[SceneParams] = None,
    device=None,
) -> Callable[[SceneParams, torch.Tensor], torch.Tensor]:
    """`(params, target [H, W, 3]) -> scalar mean squared error` with the
    rows sharded: each rank's partial sum all-reduced, over H * W * 3.
    Differentiable: its backward gives every rank the whole gradient
    (module docstring)."""
    sh = _sharding(structure, mesh, height, width, cfg, dtype, fused, interleave, balance_params,
                   device, "make_sharded_loss")
    return _sharded_loss(sh, height, width)


def _sharded_loss(sh: _Sharding, height: int, width: int) -> Callable:
    """make_sharded_loss's function over the sharding `sh`."""

    def loss(params: SceneParams, target: torch.Tensor) -> torch.Tensor:
        params = _replicated(params_to(params, device=sh.device, dtype=torch.float32), sh.shard)
        target = torch.as_tensor(target).to(device=sh.device, dtype=torch.float32)
        local = ((sh.render_rows(params, sh.rows) - target[sh.rows]) ** 2).sum()
        if sh.shard.size > 1:
            local = _AllReduceSum.apply(local, sh.shard.group)
        return true_div(local, height * width * 3)

    return loss


def make_sharded_train_step(
    structure: SceneStructure,
    mesh: DeviceMesh,
    height: int,
    width: int,
    optimizer: torch.optim.Optimizer,
    cfg: RenderConfig = DEFAULT_CONFIG,
    dtype: torch.dtype = torch.float32,
    project: Optional[Callable[[SceneParams], SceneParams]] = None,
    fused: str = "auto",
    interleave: bool = True,
    balance_params: Optional[SceneParams] = None,
    device=None,
) -> Callable[[SceneParams, torch.Tensor], torch.Tensor]:
    """`step(params, target) -> loss` for inverse rendering: the sharded
    loss, its backward (the gradient all-reduced), `optimizer.step()` and
    `project`, in place. params are the optimizer's own tensors
    (opt.trainable_leaves and opt.masked_optimizer, whose state each rank
    keeps, replicated); every rank ends the step with the same params,
    bitwise. Returns the loss before the update (detached; a tensor of its
    own, which later steps do not overwrite). Where `graphed_step` holds,
    the forward and backward run as one CUDA graph from the second call
    on (module docstring): from then on the leaves' `.grad` are buffers
    that each step overwrites (clone one to keep it). Its phases are the
    spans `step.forward` and `step.backward` (an eager step),
    `step.capture` (the graph's capture) or `step.replay`, and
    `step.update` (utils/tracing.py)."""
    sh = _sharding(structure, mesh, height, width, cfg, dtype, fused, interleave, balance_params,
                   device, "make_sharded_train_step")
    loss_fn = _sharded_loss(sh, height, width)
    graphs = graphed_step(structure, sh.cfg, fused, sh.device, sh.shard.size)
    device = sh.device
    if graphs and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    graph: Optional[_StepGraph] = None
    warm = None  # the key of the last eager step

    def eager(params: SceneParams, target: torch.Tensor) -> torch.Tensor:
        global eager_steps
        eager_steps += 1
        optimizer.zero_grad(set_to_none=True)
        with tracing.span("step.forward"):
            loss = loss_fn(params, target)
        with tracing.span("step.backward"):
            loss.backward()
        return loss.detach()

    def step(params: SceneParams, target: torch.Tensor) -> torch.Tensor:
        nonlocal graph, warm
        key = _graph_key(params, target, device) if graphs else None
        if key is not None and graph is not None and graph.key == key:
            loss = graph.replay(params)
        elif key is not None and key == warm:
            graph = None  # the next capture may share its pool
            graph = _StepGraph(key, loss_fn, optimizer, params, target, device)
            loss = graph.replay(params)
        else:
            warm = key
            loss = eager(params, target)
        with tracing.span("step.update"):
            optimizer.step()
            if project is not None:
                with torch.no_grad():
                    projected = project(params)
                    for f in FIELDS:
                        getattr(params, f).copy_(getattr(projected, f))
        return loss

    return step


def _graph_key(params: SceneParams, target, device: torch.device) -> Optional[tuple]:
    """What a captured step reads: the address, shape, strides, dtype and
    requires_grad of every params field and of the target; None when one
    is not a tensor on `device` (its copy there cannot be captured)."""
    key = []
    for t in [getattr(params, f) for f in FIELDS] + [target]:
        if not isinstance(t, torch.Tensor) or t.device != device:
            return None
        key.append((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.requires_grad))
    return tuple(key)


# Per device, the last graph captured there, a weak reference to the
# _StepGraph that replays it, and the stream it was captured on. Once that
# _StepGraph is gone (its train step died or dropped it) the graph never
# runs again, and the next capture shares its memory pool, on the same
# stream (the allocator reuses a free block only on the stream that
# allocated it): fit_scene's jobs, one graph each, capture into the blocks
# their predecessor freed and neither free nor allocate device memory (a
# torch.cuda.empty_cache() a job stalled jobs by 0.1–0.3 s at times). A
# pool whose graph can still replay is never shared: its replays write its
# free blocks.
_last_graph: Dict[torch.device, tuple] = {}


class _StepGraph:
    """The loss and its backward of one train step, captured as a CUDA
    graph. Its static outputs are the loss and the `.grad` of each params
    leaf that got one; every replay overwrites them, and no step zeroes
    them in between. Its memory pool is its own, or a dead graph's
    (`_last_graph`)."""

    def __init__(self, key, loss_fn, optimizer, params, target, device):
        global graph_captures
        optimizer.zero_grad(set_to_none=True)  # backward then allocates them in the graph
        last = _last_graph.get(device)
        if last is not None and last[1]() is None:
            pool, stream = last[0].pool(), last[2]
        else:
            pool, stream = None, torch.cuda.Stream(device)
        self.graph = torch.cuda.CUDAGraph()
        stream.wait_stream(torch.cuda.current_stream(device))
        with tracing.span("step.capture"), torch.cuda.stream(stream):
            self.graph.capture_begin(pool=pool)
            try:
                loss = loss_fn(params, target)
                loss.backward()
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)
        self.key = key
        self.loss = loss.detach()
        self.grads = [(f, getattr(params, f).grad) for f in FIELDS
                      if getattr(params, f).grad is not None]
        _last_graph[device] = (self.graph, weakref.ref(self), stream)
        graph_captures += 1

    def replay(self, params: SceneParams) -> torch.Tensor:
        """One step's loss and gradients: the graph launched, the leaves'
        `.grad` its outputs again (a caller may have set them to None)."""
        global graph_replays
        with tracing.span("step.replay"):
            self.graph.replay()
        for f, g in self.grads:
            leaf = getattr(params, f)
            if leaf.grad is not g:
                leaf.grad = g
        graph_replays += 1
        return self.loss.clone()
