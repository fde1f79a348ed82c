"""Checkpoint manager: step-numbered directories, retention policy, async
background saves, and exact resume (params + optimizer + data cursor +
RNG seed) (port of ``repro.checkpoint.manager``).
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import re
import shutil
from typing import Any, Optional

from repro_torch.checkpoint.store import to_plain, load_tree, save_tree

_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pool = cf.ThreadPoolExecutor(max_workers=1) if async_save else None
        self._pending: Optional[cf.Future] = None

    # ------------------------------------------------------------- queries
    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # --------------------------------------------------------------- save
    def save(self, step: int, params: Any, opt_state: Any = None,
             extra: Optional[dict] = None, block: bool = False) -> None:
        # copy to host numpy first: the background write must not see the
        # next train step's tensors
        tree = {"params": params}
        if opt_state is not None:
            tree["opt_state"] = opt_state
        host = to_plain(tree)
        meta = dict(extra or {})
        meta["step"] = step

        def do_save():
            save_tree(os.path.join(self.dir, f"step_{step}"), host, meta)
            self._gc()

        self.wait()
        if self._pool is not None and not block:
            self._pending = self._pool.submit(do_save)
        else:
            do_save()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def close(self) -> None:
        """Finish a pending save and stop the writer thread."""
        self.wait()
        if self._pool is not None:
            self._pool.shutdown()

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def restore(self, step: Optional[int] = None, device="cuda"):
        """Returns (step, params, opt_state_or_None, extra) with tensors on
        ``device``, or None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        tree, extra = load_tree(os.path.join(self.dir, f"step_{step}"),
                                device=device)
        return step, tree["params"], tree.get("opt_state"), extra
