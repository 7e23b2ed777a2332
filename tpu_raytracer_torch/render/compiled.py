"""The jit boundary: a frame entry point captured once per static config
as a CUDA graph, then replayed with its runtime inputs copied in.

Counterpart of ``jax.jit`` on the JAX package's frame entry points
(``tpu_raytracer/render/pipeline.py``: the config is static, the scene
arrays and the camera are runtime arguments, so animating the camera or
the instances never recompiles). ``CompiledFrame(fn)`` wraps an eager
entry point ``fn(config, scene, K_inv, D, pose, inv_pose, ...)``:

  * An entry is keyed by every argument that is neither a tensor nor a
    scene (the frozen ``RenderConfig``, ``max_bounces``, ``samples``,
    ``shadows``, ``radius`` and the like: JAX's ``static_argnums``), the
    shape, dtype and device of every tensor argument, and, per scene, the
    identity of its bound tables (every ``SceneTensors`` field but the
    per-instance rows and the TLAS: the triangles, the per-mesh wide,
    binary and page tables, the textures), its flags and the shapes of
    its per-instance rows and TLAS. Entries are kept until ``clear()``,
    as JAX keeps its jit cache; each holds the scene it was made for, so
    no table it bound can be freed and its address reused under it.
  * Each call copies the runtime inputs (``copy_``, no reallocation) into
    the entry's static buffers on the scene's device: the tensor
    arguments (the camera's ``K_inv``, ``D``, ``pose``, ``inv_pose``; the
    path and AO ``key``), and per scene the rows ``update_instance``
    replaces (``INSTANCE_FIELDS``) and its TLAS tables. A new pose, an
    instance update or a new key replays the entry; a scene with other
    bound tables, or inputs of another shape, gets an entry of its own.
  * On CUDA the first call of an entry runs the body once eagerly on a
    side stream (which builds and loads the kernel library before any
    capture), captures it into a ``torch.cuda.CUDAGraph`` with a private
    memory pool, and every call replays that graph and returns a clone of
    its outputs (a later replay writes the same memory). A failed capture
    or replay raises with the entry's key; nothing falls back to the
    eager frame.
  * On the CPU (the caller asked for it) the same binding runs with no
    capture: the inputs are copied into the buffers and the body runs on
    them, so the CPU tests see a stale frame where an input is not bound.
  * No compiled frame may be called from inside another's body (a
    capture cannot nest): such a call raises.

The sharded entries (``parallel/sharding.py``, ``parallel/scene_shard.py``)
are compiled per rank. A ``parallel.group.Group`` argument is static: its
rank, world size, device, backend and process group are part of the key,
so each group gets entries of its own, and they hold its process group:
clear them (``render.pipeline.clear_compiled``) before the group is
destroyed, as the ranks of ``parallel.spawn`` do. A ``SceneShard`` counts as a
scene: its chunk's tables are bound as a scene's, its chunk's
per-instance rows are runtime inputs (one instance, no TLAS), and its
``shard``, ``n_shards`` and ``stride`` are static. A frame made with
``collectives=True`` (the scene shards) runs ``all_reduce``s in its
body, and on CUDA they are captured into its graph:

  * only NCCL collectives can be: a gloo group moves CUDA tensors through
    host memory, so such a frame raises a ``ValueError`` for a gloo group
    on CUDA before any entry is made (on the CPU it runs as above);
  * the eager warm-up runs on the stream the capture then uses and makes
    the group's first collectives there, so the NCCL communicator exists
    before the capture, and ``torch.cuda.graph`` synchronizes the device
    before it begins, so no collective is outstanding;
  * the capture keeps ``torch.cuda.graph``'s default ``global`` error
    mode: the warm-up's collectives are complete before the capture
    begins, and NCCL collectives capture under it (``chip_smoke.py``'s
    ``[graph_shard]`` holds the captured scene-shard frames to their
    eager ones), so ``thread_local`` is not needed;
  * every rank must capture, and later replay, the same collectives in
    the same order: the key is the same on every rank (same config, same
    shapes), so each rank's first call captures and each later call
    replays. A rank that replays alone, or makes a new entry while the
    others replay, hangs in its collectives until the group's timeout.

The kernel wrappers count their launches in ``kernels.build.LAUNCHES``
(``launch_counts``), which move while the body runs eagerly or is
captured and not when a graph replays. An entry records each counter's
increase during its capture as ``launches``: the kernel launches of one
replay.

Tracing (``utils/profiling.py``, on while a ``torch.profiler`` session
runs): a call is the span ``frame`` (its index the entry's ``replays``
before the call), with the children ``bind``, ``replay`` and ``clone``;
the capture is the set-up span ``setup.capture``, whose duration is the
entry's ``capture_s``. While the body is captured its stages record the
capture's node count (``profiling.StageMap``), kept as the entry's
``stages``, ``(name, first_node, end_node)``, and ``nodes``, the kernel,
memcpy and memset nodes of its graph: node k is the k-th device operation
of every replay. A call's device operations are ``bind_ops`` copies, the
replay's ``nodes``, then ``clone_ops`` copies.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading

import torch

from ..kernels.build import LAUNCHES
from ..utils import profiling

# the scene's per-instance rows: what SceneTensors.update_instance
# replaces besides the TLAS
INSTANCE_FIELDS = ("inst_mesh", "inst_material", "inst_pose", "inst_inv_pose", "inst_scale",
                   "inst_inv_scale")
TLAS_FIELDS = ("code", "box", "inst_ids")
SCENE_FLAGS = ("has_sky", "has_textures", "has_emissive")


def launch_counts() -> dict:
    """A copy of every kernel's launch count (``kernels.build.LAUNCHES``),
    by kernel name."""
    return dict(LAUNCHES)


def _scene_of(x):
    """The ``SceneTensors`` of a scene argument (a ``SceneShard``'s chunk),
    else None."""
    from ..parallel.scene_shard import SceneShard
    from ..scene.scene import SceneTensors

    if isinstance(x, SceneShard):
        return x.scene
    return x if isinstance(x, SceneTensors) else None


def _is_scene(x) -> bool:
    return _scene_of(x) is not None


def _is_group(x) -> bool:
    from ..parallel.group import Group

    return isinstance(x, Group)


def _group_of(args, kwargs):
    """The ``parallel.group.Group`` among a call's arguments, else None."""
    return next((x for x in list(args) + list(kwargs.values()) if _is_group(x)), None)


def _tensor_spec(x: torch.Tensor) -> tuple:
    return (tuple(x.shape), x.dtype, x.device)


def _scene_runtime(scene) -> list:
    """The scene's runtime tensors, in binding order: its per-instance
    rows, then its TLAS tables where it has them."""
    rows = [getattr(scene, f) for f in INSTANCE_FIELDS]
    if scene.tlas is not None:
        rows += [getattr(scene.tlas, f) for f in TLAS_FIELDS]
    return rows


def _scene_key(x) -> tuple:
    scene = _scene_of(x)
    if scene is not x:  # a SceneShard: its place is static
        return ("shard", x.shard, x.n_shards, x.stride) + _scene_key(scene)
    bound = tuple((f.name, id(getattr(scene, f.name))) for f in dataclasses.fields(scene)
                  if f.name not in INSTANCE_FIELDS + SCENE_FLAGS + ("tlas",))
    return ("scene", bound, tuple(getattr(scene, f) for f in SCENE_FLAGS),
            scene.tlas is not None, tuple(_tensor_spec(x) for x in _scene_runtime(scene)))


def _spec(x):
    """One argument's part of the key."""
    if isinstance(x, torch.Tensor):
        return ("tensor",) + _tensor_spec(x)
    if _is_scene(x):
        return _scene_key(x)
    if _is_group(x):
        import torch.distributed as dist

        # the process group itself (the default one where pg is None) is in
        # the key: its communicator is what the captured collectives use
        return ("group", x.rank, x.world_size, x.device, x.backend,
                x.pg if x.pg is not None else dist.group.WORLD)
    try:
        hash(x)
    except TypeError:
        raise TypeError(f"a static argument of a compiled frame must be hashable, got "
                        f"{type(x).__name__}") from None
    return ("static", x)


def _runtime(x) -> list:
    """One argument's runtime tensors, in binding order."""
    if isinstance(x, torch.Tensor):
        return [x]
    if _is_scene(x):
        return _scene_runtime(_scene_of(x))
    return []


def _device(args, kwargs) -> torch.device:
    """The frame's device: its scene's."""
    for x in list(args) + list(kwargs.values()):
        if _is_scene(x):
            return _scene_of(x).device
    raise TypeError("a compiled frame takes a scene argument")


def _module_attr(module: str, name: str):
    return getattr(importlib.import_module(module), name)


# set while a compiled body runs or is captured on this thread
_in_body = threading.local()


@contextlib.contextmanager
def _body():
    _in_body.active = True
    try:
        yield
    finally:
        _in_body.active = False


class FrameEntry:
    """One compiled entry: the static buffers its body reads, its graph
    on CUDA, and what its capture recorded."""

    def __init__(self, name: str, fn, key: tuple, args: tuple, kwargs: dict):
        self.name, self.fn, self.key = name, fn, key
        self.device = _device(args, kwargs)
        self.buffers: list[torch.Tensor] = []
        self.args = tuple(self._static(x) for x in args)
        self.kwargs = {k: self._static(v) for k, v in kwargs.items()}
        self.graph = None
        self.out = None
        self.launches: dict = {}  # kernel launches per replay, from the capture
        self.stages: list = []  # (name, first_node, end_node), from the capture
        self.nodes = None  # kernel, memcpy and memset nodes of the graph
        self.replays = 0  # frames run: graph replays on CUDA, body runs on the CPU
        self.capture_s = None  # warm-up and capture, to a synchronize

    def _buffer(self, x: torch.Tensor) -> torch.Tensor:
        buf = torch.empty(x.shape, dtype=x.dtype, device=self.device)
        self.buffers.append(buf)
        return buf

    def _static(self, x):
        """The argument the body reads: a tensor's buffer, or the scene
        with buffers in place of its runtime rows and TLAS tables (its
        bound tables are the scene's own, held by this entry)."""
        if isinstance(x, torch.Tensor):
            return self._buffer(x)
        scene = _scene_of(x)
        if scene is None:
            return x
        if scene is not x:  # a SceneShard around its chunk
            return dataclasses.replace(x, scene=self._static(scene))
        rows = {f: self._buffer(getattr(x, f)) for f in INSTANCE_FIELDS}
        if x.tlas is not None:
            rows["tlas"] = dataclasses.replace(
                x.tlas, **{f: self._buffer(getattr(x.tlas, f)) for f in TLAS_FIELDS})
        return dataclasses.replace(x, **rows)

    def bind(self, args: tuple, kwargs: dict) -> None:
        """Copy a call's runtime inputs into the buffers; a scene's TLAS
        must fit the kernel's stack, as its capture checked."""
        from ..kernels.tlas import check_stack

        with profiling.span("bind"):
            sources = []
            for x in list(args) + list(kwargs.values()):
                sources += _runtime(x)
                scene = _scene_of(x)
                if scene is not None and scene.tlas is not None and self.device.type == "cuda":
                    check_stack(scene)
            for buf, src in zip(self.buffers, sources, strict=True):
                buf.copy_(src)

    @property
    def bind_ops(self) -> int:
        """Device operations of a bind: one copy per non-empty buffer."""
        return sum(1 for b in self.buffers if b.numel())

    @property
    def clone_ops(self) -> int:
        """Device operations of the outputs' clone: one copy per non-empty
        output."""
        outs = self.out.values() if isinstance(self.out, dict) else [self.out]
        return sum(1 for x in outs if x is not None and x.numel())

    def run(self):
        """The frame on the bound inputs: the body on the CPU; on CUDA,
        the graph's replay (captured on the first call) and a clone of
        its outputs."""
        if self.device.type != "cuda":
            with _body():
                out = self.fn(*self.args, **self.kwargs)
            self.replays += 1
            return out
        with torch.cuda.device(self.device):
            if self.graph is None:
                self._capture()
            try:
                with profiling.span("replay"):
                    self.graph.replay()
            except RuntimeError as e:
                raise RuntimeError(f"replay of {self.name} failed for the entry "
                                   f"{self.key}") from e
            self.replays += 1
            with profiling.span("clone"):
                if isinstance(self.out, dict):  # render_aovs
                    return {k: v.clone() for k, v in self.out.items()}
                return self.out.clone()

    def _capture(self) -> None:
        with profiling.setup("capture") as span:
            try:
                # the eager warm-up builds and loads the kernel library, so
                # no module loads inside the capture, and makes a group's
                # first collectives on the stream the capture uses
                side = torch.cuda.Stream(self.device)
                side.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(side), _body():
                    self.fn(*self.args, **self.kwargs)
                torch.cuda.current_stream(self.device).wait_stream(side)
                graph = torch.cuda.CUDAGraph()
                stages = profiling.StageMap(profiling.capture_counter(side))
                before = launch_counts()
                # torch.cuda.graph synchronizes the device before it captures
                with torch.cuda.graph(graph, stream=side), _body(), stages:
                    out = self.fn(*self.args, **self.kwargs)
                    nodes = stages.count()
                after = launch_counts()
                torch.cuda.synchronize(self.device)
            except RuntimeError as e:
                raise RuntimeError(f"capture of {self.name} failed for the entry "
                                   f"{self.key}") from e
            self.graph, self.out = graph, out
            self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            self.stages, self.nodes = stages.stages, nodes
        self.capture_s = span.seconds


class CompiledFrame:
    """``fn`` compiled per static config: calls take ``fn``'s arguments
    and return its result (see the module docstring). ``entries`` maps
    each key to its ``FrameEntry``; ``last`` is the entry of the last
    call. ``collectives``: ``fn`` runs collectives over its ``Group``
    argument, which its graph captures (NCCL only). ``name``: the entry
    point's name (default ``compiled_`` and ``fn``'s): an instance that is
    the attribute ``name`` of ``fn``'s module pickles by reference, so a
    rank started by ``parallel.spawn`` calls its own process's entry
    point."""

    def __init__(self, fn, collectives: bool = False, name: str | None = None):
        self.fn = fn
        self.name = name or "compiled_" + fn.__name__
        self.collectives = collectives
        self.entries: dict[tuple, FrameEntry] = {}
        self.last: FrameEntry | None = None
        # one call at a time binds and replays an entry's buffers
        self._lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        if getattr(_in_body, "active", False):
            raise RuntimeError(f"{self.name} was called inside a compiled frame's body; "
                               "call its eager function there")
        kwargs = dict(sorted(kwargs.items()))  # one binding order per key
        if self.collectives:
            group = _group_of(args, kwargs)
            if _device(args, kwargs).type == "cuda" and group.backend != "nccl":
                raise ValueError(
                    f"{self.name} captures its collectives into a CUDA graph, which needs "
                    f"an NCCL group; a {group.backend} group moves CUDA tensors through host "
                    "memory (call the eager entry point there)")
        key = (tuple(_spec(x) for x in args), tuple((k, _spec(v)) for k, v in kwargs.items()))
        with self._lock:
            entry = self.entries.get(key)
            new = entry is None
            if new:
                entry = FrameEntry(self.name, self.fn, key, args, kwargs)
            with profiling.span("frame", entry.replays):
                entry.bind(args, kwargs)
                out = entry.run()
            if new:  # kept once its first frame ran
                self.entries[key] = entry
            self.last = entry
            return out

    def __reduce__(self):
        return _module_attr, (self.fn.__module__, self.name)

    def clear(self) -> None:
        """Drop every entry (and with them their graphs, buffers and the
        tables they hold)."""
        with self._lock:
            self.entries.clear()
            self.last = None
