# Copy of masp_tpu/utils/downloadreader.py, verbatim apart from import paths. The port imports nothing of
# masp_tpu.
"""Lazy streaming-download reader (downloadreader.rs:6-84 equivalent).

The reference wraps a minreq lazy HTTP response in an ``io::Read`` so the
~90 MB MPC parameter files stream straight into the hash-verifying parser
without buffering whole files (masp_proofs/src/lib.rs:121-141 pipes it
through ``hashreader::HashReader``). This is the same three-state machine
(Request -> Response -> Complete) as a Python ``io.RawIOBase``:

- ``Request``: connection not opened yet; opened on first read so that
  constructing the reader is free and errors surface as read errors.
- ``Response``: bytes stream through ``readinto``.
- ``Complete(ok | error)``: EOF returns 0 forever; a failed download
  keeps raising the same error on every subsequent read, matching the
  reference's sticky-error behavior.

The opener is injectable (any ``() -> file-like``) so the state machine
is fully testable without egress; the default opener uses urllib.
"""

from __future__ import annotations

import io

__all__ = ["ResponseLazyReader", "urllib_opener"]


def urllib_opener(url: str, timeout: float | None = None):
    """Default opener: () -> file-like over the HTTP response body."""

    def open_():
        import urllib.request

        return urllib.request.urlopen(url, timeout=timeout)

    return open_


class ResponseLazyReader(io.RawIOBase):
    """io.Read over a lazily-opened download (ResponseLazyReader enum)."""

    def __init__(self, opener):
        if isinstance(opener, str):
            opener = urllib_opener(opener)
        self._opener = opener  # "Request" state while not None
        self._response = None
        self._done: bool = False
        self._error: str | None = None

    def readable(self) -> bool:
        return True

    def readinto(self, buf) -> int:
        # zero-sized buffer: nothing to do (mirrors the reference guard)
        if len(buf) == 0:
            return 0
        while True:
            if self._error is not None:
                # sticky error: every later read fails the same way
                raise OSError(self._error)
            if self._done:
                return 0
            if self._response is None:
                try:
                    self._response = self._opener()
                except Exception as e:  # noqa: BLE001 - mirror "request failed"
                    self._error = f"download request failed: {e!r}"
                    continue
            try:
                chunk = self._response.read(len(buf))
            except Exception as e:  # noqa: BLE001 - mirror "response failed"
                self._error = f"download response failed: {e!r}"
                continue
            if not chunk:
                self._done = True
                return 0
            buf[: len(chunk)] = chunk
            return len(chunk)
