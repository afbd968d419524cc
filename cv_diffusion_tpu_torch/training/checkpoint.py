"""Checkpoint save and restore with ``torch.save``, synchronous or on a
worker thread.

Counterpart of ``cv_diffusion_tpu/training/checkpoint.py``: one file holds
the update count, the parameters, the optimizer state, the EMA, the
generator's state, the epoch, the best validation loss and the training
config as JSON. Files are written atomically and read with
``weights_only=True`` (tensors, numbers and strings only).
:class:`AsyncCheckpointSaver` snapshots the state on its device and writes
it on a worker thread; :func:`save_params` writes the weights alone.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
from typing import Any, Dict, List, Optional

import torch

from .train_state import TrainState


def _build_save_item(state: TrainState) -> Dict[str, Any]:
    """The saved dict, its tensors those of the live state."""
    item = {
        "step": state.step,
        "params": {k: v.detach() for k, v in state.model.state_dict().items()},
        "opt_state": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
    }
    if state.ema_params is not None:
        item["ema_params"] = state.ema_params
    return item


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _cuda_device(tree) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``tree``, or None."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return next((d for d in map(_cuda_device, tree) if d is not None), None)
    return tree.device if isinstance(tree, torch.Tensor) and tree.is_cuda else None


def _write(path: str, item: Dict[str, Any], *, epoch: int,
           best_val_loss: float, config_json: str) -> None:
    item = dict(item, epoch=epoch, best_val_loss=float(best_val_loss),
                config=config_json)
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(item, tmp)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: TrainState, *, epoch: int,
                    best_val_loss: float, config_json: str) -> None:
    """Write the train state and host metadata to the file ``path``."""
    _write(path, _build_save_item(state), epoch=epoch,
           best_val_loss=best_val_loss, config_json=config_json)


def save_params(path: str, params: Dict[str, torch.Tensor],
                config_json: Optional[str] = None) -> None:
    """Weights-only export into the directory ``path``: ``params.npz`` in
    the port's weights format (``weights.save_state_dict_npz``) and, when
    given, ``model_config.json``."""
    from ..weights import save_state_dict_npz

    os.makedirs(path, exist_ok=True)
    save_state_dict_npz({k: v.detach().float().cpu() for k, v in params.items()},
                        os.path.join(path, "params.npz"), source="save_params")
    if config_json is not None:
        with open(os.path.join(path, "model_config.json"), "w") as f:
            f.write(config_json)


class AsyncCheckpointSaver:
    """Checkpoint saves that overlap training.

    The train step updates the state in place, so :meth:`save` first copies
    every tensor of the state on its device, enqueued on the current
    (compute) stream before the next step can touch the originals, and
    returns. A single worker thread then waits for those copies (an event,
    not a device sync), fetches them to the host on a stream of its own and
    writes the file. Saves are written in the order they were made (one
    worker, FIFO); at most ``max_pending`` snapshots are held in device
    memory (:meth:`save` blocks for the oldest beyond that); a failed write
    raises from the next call.
    """

    def __init__(self, max_pending: int = 2):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-saver")
        self._pending: List[concurrent.futures.Future] = []
        self._max_pending = max_pending
        self._stream = None

    def _snapshot(self, tree):
        """Device copies of ``tree``'s tensors and the event that marks
        their completion on the current stream (None on the CPU)."""
        snap = _tree_map(lambda t: t.detach().clone(), tree)
        device = _cuda_device(snap)
        if device is None:
            return snap, None
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        return snap, event

    def _to_host(self, snap, event):
        if event is None:
            return snap
        if self._stream is None:
            self._stream = torch.cuda.Stream(_cuda_device(snap))
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(event)
            host = _tree_map(lambda t: t.to("cpu", non_blocking=True), snap)
        self._stream.synchronize()
        return host

    def _submit(self, tree, job) -> None:
        self._reap(block_to=self._max_pending - 1)
        snap, event = self._snapshot(tree)
        self._pending.append(self._pool.submit(
            lambda: job(self._to_host(snap, event))))

    def save(self, path: str, state: TrainState, *, epoch: int,
             best_val_loss: float, config_json: str) -> None:
        self._submit(_build_save_item(state), lambda host: _write(
            path, host, epoch=epoch, best_val_loss=best_val_loss,
            config_json=config_json))

    def save_params(self, path: str, params: Dict[str, torch.Tensor],
                    config_json: Optional[str] = None,
                    sidecar: Optional[Dict[str, str]] = None) -> None:
        """:func:`save_params` on the worker; ``sidecar`` maps further file
        names to text written beside the weights (e.g. a student's timestep
        grid)."""
        def job(host):
            save_params(path, host, config_json)
            for fname, text in (sidecar or {}).items():
                with open(os.path.join(path, fname), "w") as f:
                    f.write(text)

        self._submit(dict(params), job)

    def _reap(self, block_to: int) -> None:
        """Raise the error of a finished job; block until at most
        ``block_to`` jobs are in flight."""
        while self._pending:
            fut = self._pending[0]
            if len(self._pending) <= block_to and not fut.done():
                break
            # dequeued before its error is raised, so that a failed job
            # does not raise again on every later call
            self._pending.pop(0)
            fut.result()

    def wait(self) -> None:
        """Wait for every save in flight."""
        self._reap(block_to=0)


def load_raw(path: str) -> Dict[str, Any]:
    """The saved dict, every tensor on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state: TrainState) -> Dict[str, Any]:
    """Restore ``state`` in place from ``path``; returns
    ``{"state", "epoch", "best_val_loss", "config"}`` (the trainer resumes at
    epoch + 1)."""
    raw = load_raw(path)
    state.model.load_state_dict(raw["params"], strict=True)
    state.optimizer.load_state_dict(raw["opt_state"])
    state.step = int(raw["step"])
    state.generator.set_state(raw["generator"])
    if state.ema_params is not None:
        if "ema_params" not in raw:
            raise ValueError(f"{path} holds no EMA, and this run keeps one")
        with torch.no_grad():
            for name, e in state.ema_params.items():
                e.copy_(raw["ema_params"][name])
    return {"state": state, "epoch": int(raw["epoch"]),
            "best_val_loss": float(raw["best_val_loss"]),
            "config": json.loads(raw["config"])}


def _is_package(path: str) -> bool:
    """Whether a directory with ``params.npz`` is a serving package (its
    ``model_config.json`` has the package's ``model`` section)."""
    cfg = os.path.join(path, "model_config.json")
    if not os.path.isfile(cfg):
        return False
    with open(cfg) as f:
        return "model" in json.load(f)


def load_inference_params(path: str, use_ema: bool = True,
                          verbose: bool = True) -> Dict[str, torch.Tensor]:
    """The weights to serve or to warm-start from (``TrainConfig.
    init_params_from``), as a state dict of CPU tensors, from any of the
    port's layouts (JAX ``load_inference_params``, ``checkpoint.py:234``):

    * a full checkpoint (a file of :func:`save_checkpoint`): its EMA when
      ``use_ema`` and it has one, else its raw parameters. (The JAX loader
      returns the raw parameters of a full checkpoint even when asked for
      the EMA; this one does not.)
    * a weights file in the port's format (``.npz``,
      ``weights.save_state_dict_npz``, e.g. ``artifacts_torch/<name>.npz``)
      or a serving package's or :func:`save_params` directory: its
      parameters, float32 (a package's bf16 or int8 codec brought back as
      ``load_serving_package`` does);
      ``use_ema`` is ignored with a warning, as in the JAX package (these
      hold the already-selected weights).

    The JAX package's orbax directories cannot be read here (there is no
    orbax where the card is): convert them first with
    ``scripts/torch_port_export_weights.py``."""
    if os.path.isdir(path):
        if not os.path.isfile(os.path.join(path, "params.npz")):
            raise ValueError(
                f"{path}: a directory without params.npz, such as an orbax "
                "checkpoint of the JAX package, which the port cannot read; "
                "convert it to the port's weights format with "
                "scripts/torch_port_export_weights.py")
        if _is_package(path):
            from ..export.serving import load_serving_package
            state = load_serving_package(path, "cpu")[2]
        else:       # a save_params directory
            from ..weights import load_state_dict_npz
            state = load_state_dict_npz(os.path.join(path, "params.npz"), "cpu")
    elif path.endswith(".npz"):
        from ..weights import load_state_dict_npz
        state = load_state_dict_npz(path, "cpu")
    else:
        raw = load_raw(path)
        key = "ema_params" if use_ema and "ema_params" in raw else "params"
        if use_ema and key == "params" and verbose:
            print("Warning: --use_ema requested but checkpoint has no "
                  "ema_params; using raw params")
        return dict(raw[key])
    if use_ema and verbose:
        print("Warning: --use_ema ignored (params-only artifact; packages "
              "store the already-selected weights)")
    return state
