"""One-shot worker thread wrapper (port of
gaussian_splat_ipu_tpu/ui/async_task.py, itself the reference's AsyncTask,
include/remote_ui/AsyncTask.hpp:13-66): run a callable on a second
thread; `wait_for_completion` joins it and rethrows what it raised. The
render loop overlaps the UI's encode and send with the next frame's
device work this way.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class AsyncTask:
    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._exc: Optional[BaseException] = None

    def run(self, fn: Callable[[], None]) -> None:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("AsyncTask already running; "
                               "call wait_for_completion first")
        self._exc = None

        def wrapper():
            try:
                fn()
            except BaseException as e:  # rethrown on join
                self._exc = e

        self._thread = threading.Thread(target=wrapper, daemon=True)
        self._thread.start()

    def wait_for_completion(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc
