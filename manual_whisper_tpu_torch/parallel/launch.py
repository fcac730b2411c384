"""One process a GPU for the CLI and the job server: the port's
counterpart of the JAX package's single-controller meshing
(``load_model(mesh="auto")``, whose ``_auto_mesh`` meshes every chip of
the host from one process).

PyTorch runs one process a device, so the port's ``_auto_mesh`` builds a
mesh only inside a world that is already initialised.  The CLI and the
server start that world themselves:

    python -m manual_whisper_tpu_torch.cli meeting.wav        # every GPU
    torchrun --nproc-per-node 2 -m manual_whisper_tpu_torch.cli meeting.wav
    MWX_AUTO_MESH=false python -m manual_whisper_tpu_torch.cli meeting.wav

- ``world_size_wanted`` applies the JAX ``_auto_mesh`` rule to the GPUs
  (``MWX_AUTO_MESH``, ``MWX_MODEL_PARALLEL``, ``MWX_DATA_PARALLEL``).
- ``start_world`` joins the world from the environment under ``torchrun``
  (``RANK``/``WORLD_SIZE`` set); otherwise, when more than one process is
  wanted, the calling process becomes rank 0 and starts the others, each
  running the same command with ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``
  and a file store in a temporary directory (``MWX_WORLD_STORE``).  Each
  rank takes the GPU of its local rank and NCCL (gloo for a CPU world),
  plus a gloo group for host objects.  Rank 0's children die with it
  (``PR_SET_PDEATHSIG``, and a kill when it leaves the world); a child
  that exits while rank 0 is in the world ends rank 0 with exit code 1
  (after a grace for rank 0's own error, such as a collective that lost
  its peer): rank 0 never hangs on it and never carries on alone.
- Rank 0 wraps its pipeline in ``Leader``: each ``transcribe``,
  ``warmup`` and ``detect_language`` is broadcast over the gloo group
  (audio as numpy, progress callbacks left out) and then run, both under
  one lock, so calls from rank 0's threads (the job worker, the second
  pass, the warm-up) reach every rank in one order.  Every other rank
  runs ``follow``: the same calls, in that order, until rank 0 leaves.
  Since every call runs the mesh's collectives, a call waits for the one
  before it to end.
"""

from __future__ import annotations

import atexit
import datetime
import inspect
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import config
from ..device import DeviceLike, resolve_device

STORE_ENV = "MWX_WORLD_STORE"
DEVICE_ENV = "MWX_WORLD_DEVICE"
PARENT_ENV = "MWX_WORLD_PARENT"
# seconds a collective of the world may wait (the mesh's); the followers'
# wait for rank 0's next call has no such limit (a server may idle)
DEFAULT_TIMEOUT = 600.0
IDLE_TIMEOUT = datetime.timedelta(days=365)
# seconds rank 0 is given to fail by itself after a child exited
CHILD_EXIT_GRACE = 5.0


def world_size_wanted(device: DeviceLike = "cuda") -> int:
    """Processes the CLI and the server run on: the JAX ``_auto_mesh``
    rule over ``torch.cuda.device_count()``.  ``MWX_AUTO_MESH=false``
    means one; ``MWX_MODEL_PARALLEL`` (default 1) is the model-parallel
    width; ``MWX_DATA_PARALLEL`` caps the count at that many times the
    width; a count of one or less, or one the width does not divide,
    means one.  A CPU device wants one (a CPU world is asked for by
    size)."""
    if not config.get_bool("MWX_AUTO_MESH", True):
        return 1
    if torch.device(device).type != "cuda":
        return 1
    n = torch.cuda.device_count()
    mp = config.get_int("MWX_MODEL_PARALLEL", 1)
    dp_cap = config.get_int("MWX_DATA_PARALLEL", 0)
    if dp_cap:
        n = min(n, dp_cap * mp)
    if n <= 1 or n % mp != 0:
        return 1
    return n


class World:
    """This process's place in a world started by ``start_world``:
    ``rank``, ``size``, ``device`` (its GPU, or the CPU) and ``objects``
    (the gloo group host objects cross).  A context manager: leaving it
    normally, rank 0 tells the followers to stop, and every rank leaves
    the process group (rank 0 then waits for its children, and raises if
    one failed); leaving it on an error, rank 0 kills its children."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 objects, children: Sequence[subprocess.Popen] = (),
                 workdir: Optional[str] = None):
        self.rank, self.size, self.device = rank, size, device
        self.objects = objects
        self.children: List[subprocess.Popen] = list(children)
        self._workdir = workdir
        self._leaving = False

    # -- host objects from rank 0 --------------------------------------------
    def send(self, obj) -> None:
        """Rank 0: broadcast ``obj`` (picklable) to every other rank."""
        dist.broadcast_object_list([obj], src=0, group=self.objects)

    def receive(self):
        """Every other rank: the next object rank 0 sends."""
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.objects)
        return box[0]

    # -- leaving ---------------------------------------------------------------
    def __enter__(self) -> "World":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self._kill_children()
            return
        self._leaving = True
        if self.rank == 0:
            self.send(None)
        dist.destroy_process_group()
        codes = [p.wait() for p in self.children]
        self._clean()
        if any(codes):
            raise RuntimeError(f"world ranks 1..{self.size - 1} exited with "
                               f"{codes}")

    def _kill_children(self) -> None:
        self._leaving = True
        for p in self.children:
            if p.poll() is None:
                p.kill()
        for p in self.children:
            p.wait()
        self._clean()

    def _clean(self) -> None:
        if self._workdir:
            shutil.rmtree(self._workdir, ignore_errors=True)
            self._workdir = None

    def _watch(self) -> None:
        """Rank 0's watch over its children while it is in the world."""
        while not self._leaving:
            for rank, p in enumerate(self.children, start=1):
                code = p.poll()
                if code is None or self._leaving:
                    continue
                print(f"world: rank {rank} exited with code {code}; rank 0 "
                      "stops", file=sys.stderr, flush=True)
                deadline = time.monotonic() + CHILD_EXIT_GRACE
                while time.monotonic() < deadline and not self._leaving:
                    time.sleep(0.1)
                if not self._leaving:
                    self._kill_children()
                    os._exit(1)
                return
            time.sleep(0.2)


def start_world(command: Sequence[str], device: DeviceLike = "cuda",
                world_size: Optional[int] = None,
                timeout: float = DEFAULT_TIMEOUT) -> Optional[World]:
    """Join or start the world the CLI or the server runs in; None when
    it runs in this process alone.

    Under ``torchrun`` (``RANK`` and ``WORLD_SIZE`` set) the world is
    joined from the environment (a ``MWX_WORLD_STORE`` file store, else
    ``env://``).  Otherwise ``world_size`` processes (default
    ``world_size_wanted(device)``) are wanted, and when that is more than
    one this process becomes rank 0 and starts the others as
    ``sys.executable *command`` (the command that made this call, e.g.
    ``["-m", "manual_whisper_tpu_torch.cli", "meeting.wav"]``).
    ``timeout``: seconds a collective may wait."""
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dev = torch.device(os.environ.get(DEVICE_ENV, str(device)))
        return _join(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                     int(os.environ.get("LOCAL_RANK", "0")),
                     os.environ.get(STORE_ENV), dev, timeout)
    dev = torch.device(device)
    n = world_size_wanted(dev) if world_size is None else world_size
    if n <= 1:
        return None
    if dev.type == "cuda":
        resolve_device(dev)             # raises without CUDA
    workdir = tempfile.mkdtemp(prefix="mwx-world-")
    store = os.path.join(workdir, "store")
    children = []
    try:
        for rank in range(1, n):
            env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank),
                   "WORLD_SIZE": str(n), STORE_ENV: store,
                   DEVICE_ENV: dev.type, PARENT_ENV: str(os.getpid())}
            children.append(subprocess.Popen([sys.executable, *command],
                                             env=env))
    except BaseException:
        for p in children:
            p.kill()
        shutil.rmtree(workdir, ignore_errors=True)
        raise
    world = World(0, n, dev, None, children, workdir)
    atexit.register(world._kill_children)
    threading.Thread(target=world._watch, name="mwx-world-watch",
                     daemon=True).start()
    try:
        joined = _join(0, n, 0, store, dev, timeout)
    except BaseException:
        world._kill_children()
        raise
    world.device, world.objects = joined.device, joined.objects
    return world


def _join(rank: int, size: int, local_rank: int, store: Optional[str],
          device: torch.device, timeout: float) -> World:
    """Initialise this rank's process group (NCCL on its GPU, or gloo on
    the CPU) and the gloo group of host objects."""
    if os.environ.get(PARENT_ENV):
        _die_with_parent(int(os.environ[PARENT_ENV]))
    if device.type == "cuda":
        device = resolve_device(torch.device("cuda", local_rank))
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"file://{store}" if store else "env://",
        rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=timeout))
    objects = dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)
    return World(rank, size, device, objects)


def _die_with_parent(parent: int) -> None:
    """A child of rank 0: be killed when rank 0 dies (Linux's
    ``PR_SET_PDEATHSIG``), and exit now if it died already."""
    try:
        import ctypes
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


# ---------------------------------------------------------------------------
# Rank 0 leads, the others follow
# ---------------------------------------------------------------------------

# the pipeline methods that reach every rank; the arguments that stay on
# rank 0 (callbacks and prints)
CALLS = ("transcribe", "warmup", "detect_language")
LOCAL_ARGS = ("progress_callback", "verbose")


class Leader:
    """Rank 0's pipeline in a world: ``transcribe``, ``warmup`` and
    ``detect_language`` are sent to every rank and then run here, under
    one lock; every other attribute is the pipeline's.  ``calls`` counts
    the calls sent."""

    def __init__(self, pipeline, world: World):
        self.pipeline = pipeline
        self.world = world
        self.calls = 0
        self._lock = threading.Lock()

    def __getattr__(self, name):
        return getattr(self.pipeline, name)

    def transcribe(self, audio, *args, **kwargs) -> dict:
        if isinstance(audio, (str, Path)):
            from ..audio import load_audio
            audio = load_audio(audio)
        return self._call("transcribe", np.asarray(audio, np.float32),
                          *args, **kwargs)

    def warmup(self, *args, **kwargs) -> None:
        return self._call("warmup", *args, **kwargs)

    def detect_language(self, audio) -> str:
        return self._call("detect_language", np.asarray(audio, np.float32))

    def _call(self, name: str, *args, **kwargs):
        method = getattr(self.pipeline, name)
        bound = inspect.signature(method).bind(*args, **kwargs).arguments
        sent = {k: v for k, v in bound.items() if k not in LOCAL_ARGS}
        with self._lock:
            self.world.send((name, sent))
            self.calls += 1
            return method(*args, **kwargs)


def follow(pipeline, world: World) -> int:
    """Every rank but 0: run rank 0's calls on ``pipeline`` in the order
    sent, with no progress callback and no prints, dropping the results,
    until rank 0 leaves the world; returns the calls run.  A call that
    raises ends the follower (and so the world)."""
    n = 0
    while True:
        msg = world.receive()
        if msg is None:
            return n
        name, kwargs = msg
        if name not in CALLS:
            raise ValueError(f"follow: no pipeline call {name!r}")
        getattr(pipeline, name)(**kwargs)
        n += 1
