"""Render engine lifecycle: device selection, graph capture, program
registry (torch port of gaussian_splat_ipu_tpu/runtime/engine.py).

The reference compiles each named program once, ahead of time
(`jax.jit(fn).lower(...).compile()`, engine.py:120-123), and then runs the
executable by name. The port's counterpart of "compile once, replay by
name" is a `torch.cuda.CUDAGraph`: `register` builds the CUDA kernels,
warms `fn` up on a side stream and captures one call of it; `run` copies
its arguments into the captured call's input tensors and replays the
graph. One replay issues the whole frame (hundreds of kernels) with one
host call.

Static inputs. The tensors of `example_args` (tensors, the parameters and
buffers of nn.Module arguments such as GaussianModel, and a Camera's view,
projection and environment rotation) ARE the graph's inputs: the engine owns them after `register`. `run` copies each tensor
argument into its input unless the argument is that very tensor, so a
model passed again as registered (about 236 MB at 1M gaussians) costs
nothing per frame, while a camera made anew on the host each frame is
copied in (a few hundred bytes). Arguments that are not tensors are baked
into the graph and must equal the registered ones. A program therefore
must not turn host values into device tensors itself (a copy from
pageable host memory cannot be captured): the app computes each frame's
camera on the host and passes its view, projection and environment
rotation as tensors.

Outputs. A replay writes the same output memory every time, so `run`
hands back clones of the outputs, made on the stream right after the
replay: a frame the caller still holds (frames in flight, a PNG dump, a UI
push) survives the next replay.

Train programs (`register(..., grad=True)`). A train step runs forward,
backward and an optimizer update that writes the parameters and the
optimizer state in place; the state is passed to `run` as the registered
object, so nothing of it is copied, and the program returns only its loss.
Its warm-ups and its capture run with autograd on (render programs run
under `torch.inference_mode()`), and, since each warm-up is a real update,
every input tensor is copied aside before the warm-ups and copied back in
place after the capture: after `register` the state is as it was.

Re-registration. Registering a name again replaces its program, as a
recompile replaces an executable in the reference: the old graph is reset
and its outputs dropped before the new capture, and the caching allocator
releases the old graph's private memory pool (`torch.cuda.empty_cache`),
so a train program re-captured at each SH bump or capacity doubling holds
one pool, not one per capture. Warm-ups and captures run on one side
stream per device, shared by every registration: cuBLAS keeps a workspace
for each (handle, stream) it meets, for the life of the process, so a new
stream per registration would leave workspaces behind at each one, and
one first met inside a capture would be made in that graph's pool and
keep the pool from ever being freed. On the shared stream the warm-ups
make them once, outside any capture.

On the CPU (`device="cpu"`) a program is stored as it is and `run` calls it
eagerly; nothing is captured. On CUDA there is no such fallback: a
function that cannot be captured makes `register` raise. The one program
that runs eagerly on CUDA is one registered with a reason for it
(`eager=`): a sharded program over a mesh whose shards sit on several
devices (parallel/distributed.py), whose peer copies a graph on one device
does not capture. The reason is logged at registration and shows in the
manifest.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import torch
from torch import nn
from torch.utils import _pytree as pytree

from gaussian_splat_ipu_tpu_torch.models.camera import Camera
from gaussian_splat_ipu_tpu_torch.render.kernels import cuda_lib
from gaussian_splat_ipu_tpu_torch.utils.config import RuntimeConfig

log = logging.getLogger("gsplat")

# The reference's --log-level strings (options.hpp:24-45).
LOG_LEVELS = {"trace": logging.DEBUG, "debug": logging.DEBUG,
              "info": logging.INFO, "warn": logging.WARNING,
              "err": logging.ERROR, "off": logging.CRITICAL}
# Calls of a program on a side stream before its capture: they build the
# kernels' lazy state (cuBLAS and cuDNN handles and workspaces, autograd's,
# cached constants such as the row buckets' bounds tensor) outside the
# graph.
WARMUP_CALLS = 3
# The side stream of each device that warm-ups and captures run on (module
# docstring: one per device, for the process).
_CAPTURE_STREAMS: Dict[int, Any] = {}


def setup_logging(level: str = "info") -> None:
    """Map the reference's --log-level strings to logging levels."""
    logging.basicConfig(
        level=LOG_LEVELS.get(level, logging.INFO),
        format="[%(asctime)s] [%(levelname)s] %(message)s",
        datefmt="%H:%M:%S")


def select_device(device: str = "cuda") -> torch.device:
    """The compute device: the CPU only when asked for ("cpu"); otherwise
    a CUDA device, and without one this raises (the reference falls back
    to the CPU, engine.py:46-56; the port never does)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device {device!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA device is available")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _tensors_of(leaf) -> List[torch.Tensor]:
    """The input tensors an argument leaf stands for."""
    if isinstance(leaf, torch.Tensor):
        return [leaf]
    if isinstance(leaf, nn.Module):
        return list(leaf.parameters()) + list(leaf.buffers())
    if isinstance(leaf, Camera):
        return [leaf.view, leaf.proj, leaf.env_rot]
    return []


@dataclasses.dataclass
class CompiledProgram:
    name: str
    fn: Callable
    compile_seconds: float          # warm-up + capture (0 on the CPU)
    graph: Optional[Any] = None     # torch.cuda.CUDAGraph on CUDA
    in_leaves: tuple = ()           # flattened registered arguments
    in_spec: Any = None
    out_leaves: tuple = ()          # flattened captured outputs
    out_spec: Any = None
    grad: bool = False              # runs with autograd (a train step)
    eager: str = ""                 # why it runs uncaptured on CUDA


class RenderEngine:
    """Named-program registry + graph capture + replay.

    Usage:
        eng = RenderEngine(RuntimeConfig(device="cuda"))
        eng.register("render", fn, example_args)   # warm-up + capture
        out = eng.run("render", *args)             # copy-in + replay
    """

    def __init__(self, config: RuntimeConfig = RuntimeConfig()):
        self.config = config
        self.programs: Dict[str, CompiledProgram] = {}
        self.device = select_device(config.device)
        log.info("engine device: %s", self.device)

    def register(self, name: str, fn: Callable, example_args: tuple,
                 grad: bool = False, eager: str = "") -> CompiledProgram:
        """Capture `fn(*example_args)` into a CUDA graph (on the CPU: store
        `fn`). Every tensor in example_args must lie on the engine's
        device; those tensors become the graph's static inputs. Raises if
        the call cannot be captured. grad=True: a train program (module
        docstring), warmed up and captured with autograd on, its inputs
        restored after the capture. A rate-limited heartbeat logs the
        elapsed time of long registrations (the reference's compile
        progress filter, engine.py:104-126). A program already registered
        under `name` is released first (module docstring). eager: a reason
        to store fn uncaptured on CUDA too, logged (module docstring)."""
        self.release(name)
        leaves, spec = pytree.tree_flatten(tuple(example_args))
        for leaf in leaves:
            for t in _tensors_of(leaf):
                if t.device != self.device:
                    raise ValueError(f"program '{name}': an example tensor "
                                     f"is on {t.device}, the engine on "
                                     f"{self.device}")
        prog = CompiledProgram(name=name, fn=fn, compile_seconds=0.0,
                               in_leaves=tuple(leaves), in_spec=spec,
                               grad=grad, eager=eager)
        if eager:
            log.info("program '%s' runs eagerly: %s", name, eager)
        elif self.device.type == "cuda":
            t0 = time.perf_counter()
            done = threading.Event()

            def heartbeat():
                interval = 15.0   # short captures stay silent
                while not done.wait(interval):
                    log.info("capturing program '%s'... %.0fs elapsed",
                             name, time.perf_counter() - t0)
                    interval = min(interval * 2, 120.0)

            ticker = threading.Thread(target=heartbeat, daemon=True)
            ticker.start()
            try:
                prog.graph, out = self._capture(name, fn, example_args,
                                                grad)
            finally:
                done.set()
                ticker.join()
            outs, prog.out_spec = pytree.tree_flatten(out)
            prog.out_leaves = tuple(outs)
            prog.compile_seconds = time.perf_counter() - t0
            log.info("captured program '%s' in %.2fs", name,
                     prog.compile_seconds)
        self.programs[name] = prog
        return prog

    def release(self, name: str) -> None:
        """Drop the program `name` if there is one: reset its graph, drop
        its captured inputs and outputs, and hand its memory pool back to
        the device."""
        prog = self.programs.pop(name, None)
        if prog is None:
            return
        prog.in_leaves = prog.out_leaves = ()
        if prog.graph is not None:
            prog.graph.reset()
            prog.graph = None
            torch.cuda.empty_cache()

    def _capture(self, name: str, fn: Callable, args: tuple, grad: bool):
        """Build the kernels, run fn WARMUP_CALLS times on the device's
        side stream, then capture one call on it; with `grad`, under
        autograd, and the input tensors copied back in place to what they
        held before the warm-ups. Returns (graph, captured outputs)."""
        cuda_lib.library()
        dev = self.device
        inputs = [t for leaf in pytree.tree_leaves(tuple(args))
                  for t in _tensors_of(leaf)]
        with torch.no_grad():
            saved = [t.detach().clone() for t in inputs] if grad else []
        with torch.cuda.device(dev):
            side = _CAPTURE_STREAMS.get(dev.index)
            if side is None:
                side = _CAPTURE_STREAMS[dev.index] = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), torch.inference_mode(not grad):
                for _ in range(WARMUP_CALLS):
                    fn(*args)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph, stream=side), \
                        torch.inference_mode(not grad):
                    out = fn(*args)
            except Exception as e:
                raise RuntimeError(f"program '{name}' could not be captured "
                                   f"into a CUDA graph: {e}") from e
            with torch.no_grad():
                for t, s in zip(inputs, saved):
                    t.copy_(s)
        return graph, out

    def _load_inputs(self, prog: CompiledProgram, args: tuple) -> None:
        """Copy each tensor argument into its static input, skipping the
        ones that are the static input itself."""
        leaves, spec = pytree.tree_flatten(tuple(args))
        if spec != prog.in_spec:
            raise TypeError(f"program '{prog.name}': arguments {spec} do not "
                            f"match the registered {prog.in_spec}")
        for new, static in zip(leaves, prog.in_leaves):
            if new is static:
                continue
            dst, src = _tensors_of(static), _tensors_of(new)
            if not dst and not src:
                if new != static:
                    raise ValueError(f"program '{prog.name}' was captured "
                                     f"with {static!r}, got {new!r}")
                continue
            if len(dst) != len(src):
                raise TypeError(f"program '{prog.name}': {type(new)} does "
                                f"not match the registered {type(static)}")
            for d, s in zip(dst, src):
                if s is d:
                    continue
                if s.shape != d.shape or s.dtype != d.dtype:
                    raise ValueError(
                        f"program '{prog.name}': a {s.dtype} tensor of shape "
                        f"{tuple(s.shape)} for the captured {d.dtype} "
                        f"{tuple(d.shape)}")
                d.copy_(s, non_blocking=True)

    def run(self, name: str, *args):
        """Run a registered program by name (ProgramManager::run parity):
        on CUDA copy the arguments in, replay, and return clones of the
        outputs; on the CPU call the function."""
        if name not in self.programs:
            raise KeyError(f"Tried to run unregistered program: '{name}'")
        prog = self.programs[name]
        with torch.inference_mode(not prog.grad):
            if prog.graph is None:
                return prog.fn(*args)
            with torch.no_grad():
                self._load_inputs(prog, args)
            prog.graph.replay()
            return pytree.tree_unflatten(
                [t.clone() if isinstance(t, torch.Tensor) else t
                 for t in prog.out_leaves], prog.out_spec)

    def manifest(self) -> str:
        """JSON program listing (ProgramManager::serialise parity)."""
        return json.dumps({
            "programs": {
                n: {"compile_seconds": round(p.compile_seconds, 3),
                    "cuda_graph": p.graph is not None,
                    **({"eager": p.eager} if p.eager else {})}
                for n, p in self.programs.items()
            },
            "device": str(self.device),
        }, indent=2)

    def memory_stats(self) -> Optional[dict]:
        """The CUDA caching allocator's statistics; None on the CPU."""
        if self.device.type != "cuda":
            return None
        return torch.cuda.memory_stats(self.device)
