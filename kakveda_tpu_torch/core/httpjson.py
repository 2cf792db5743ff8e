"""Blocking JSON over HTTP from the standard library.

The synchronous half of the fleet's HTTP: ``replay_dlq_file``'s one POST
per dead-lettered event, the range migration's export / ship / flip
(``fleet/ownership.run_rebalance``) and the supervisor's readiness poll.
The reference speaks these through ``httpx``; the port keeps to
``urllib`` so a machine without ``httpx`` runs the whole fleet (the async
paths use aiohttp). Proxies from the environment are ignored: every
peer is a direct address.
"""

from __future__ import annotations

import http.client
import json
import urllib.error
import urllib.request
from typing import Any, Tuple

_OPENER = urllib.request.build_opener(urllib.request.ProxyHandler({}))


class HTTPStatusError(OSError):
    """A non-2xx answer (``status``, ``body``). A request that got no
    answer (refused, reset, timed out) raises another ``OSError``."""

    def __init__(self, status: int, body: bytes, url: str):
        super().__init__(f"HTTP {status} from {url}")
        self.status = status
        self.body = body


def request(
    method: str, url: str, obj: Any = None, timeout: float = 5.0
) -> Tuple[int, bytes]:
    """One request with an optional JSON body; returns (status, body) for
    a 2xx answer and raises :class:`HTTPStatusError` for any other, or an
    ``OSError`` when the request never got an answer."""
    data = None if obj is None else json.dumps(obj).encode("utf-8")
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with _OPENER.open(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        body = e.read() if e.fp is not None else b""
        raise HTTPStatusError(e.code, body, url) from None
    except http.client.HTTPException as e:  # a torn answer: a transport error
        raise ConnectionError(f"{type(e).__name__}: {e}") from e


def post_json(url: str, obj: Any, timeout: float = 5.0) -> Any:
    """POST ``obj`` as JSON; the parsed JSON answer (None when empty)."""
    _, body = request("POST", url, obj, timeout)
    return json.loads(body) if body.strip() else None
