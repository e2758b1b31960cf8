"""Token-validation client with a bounded TTL cache.

Analog of the reference Python server stack's auth client
(lib/KmerGutsJava/authclient.py:24-91: a KBase ``KBaseAuth`` that resolves
a bearer token to a user id via an external auth service, fronted by a
``TokenCache``). Upstream it is dead scaffolding (nothing in the empty
KIDL module authenticates); here it is wired into the live server:
``server.py --auth-url`` validates every request's ``Authorization``
header through ``AuthClient.get_user`` instead of a static ``--token``
compare, so a deployment can sit behind a real identity service.

Cache semantics reproduce the reference exactly (same knobs so a KBase
operator's sizing carries over):

- entries keyed by sha256(token) — raw credentials never sit in memory
  (ref authclient.py:27, :42);
- 5-minute validity window per cached entry (ref :17 ``_MAX_TIME_SEC``);
- bounded at ``maxsize`` (default 2000); on overflow the OLDEST half of
  the entries is evicted in one sweep (ref :44-51), amortizing the sort.

The transport is stdlib urllib (this repo's clients are dependency-free)
POSTing ``token=...&fields=user_id`` and reading ``user_id`` from the
JSON reply — the wire shape of the reference's login endpoint (ref
:76-91).
"""
from __future__ import annotations

import hashlib
import json
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional


class AuthError(Exception):
    """Token rejected, or the auth service was unreachable/malformed."""


class TokenCache:
    """Bounded TTL cache of token-hash -> user (ref authclient.py:14-51)."""

    MAX_TIME_SEC = 5 * 60  # ref :17

    def __init__(self, maxsize: int = 2000):
        self._cache: dict = {}  # sha256(token) -> [user, inserted_at]
        self._maxsize = maxsize
        self._halfmax = maxsize // 2  # ref :23 (int division)
        self._lock = threading.RLock()

    @staticmethod
    def _key(token: str) -> str:
        return hashlib.sha256(token.encode()).hexdigest()

    def get_user(self, token: str) -> Optional[str]:
        with self._lock:
            usertime = self._cache.get(self._key(token))
        if not usertime:
            return None
        user, intime = usertime
        if time.time() - intime > self.MAX_TIME_SEC:
            return None  # stale entry; caller re-validates (ref :33-35)
        return user

    def add_valid_token(self, token: str, user: str) -> None:
        if not token:
            raise ValueError("Must supply token")  # ref :39
        if not user:
            raise ValueError("Must supply user")  # ref :41
        with self._lock:
            self._cache[self._key(token)] = [user, time.time()]
            if len(self._cache) > self._maxsize:
                # evict the oldest half in one sweep (ref :44-51)
                by_age = sorted(self._cache.items(), key=lambda kv: kv[1][1])
                for i, (k, _) in enumerate(by_age):
                    if i <= self._halfmax:
                        del self._cache[k]
                    else:
                        break


class AuthClient:
    """Resolve a token to a user id via an auth endpoint, cached.

    ``get_user`` raises AuthError for rejected tokens and transport
    failures; callers (server.py) map that to the JSON-RPC auth error."""

    def __init__(self, auth_url: str, cache: Optional[TokenCache] = None,
                 timeout: float = 10.0):
        self.auth_url = auth_url
        self.timeout = timeout
        self._cache = cache if cache is not None else TokenCache()

    def get_user(self, token: str) -> str:
        if not token:
            raise AuthError("Must supply token")  # ref :71-72
        user = self._cache.get_user(token)
        if user:
            return user
        data = urllib.parse.urlencode(
            {"token": token, "fields": "user_id"}).encode()  # ref :76
        req = urllib.request.Request(
            self.auth_url, data=data,
            headers={"Content-Type": "application/x-www-form-urlencoded"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                body = json.load(resp)
        except urllib.error.HTTPError as ex:
            try:
                err = json.load(ex)
                msg = err.get("error_msg", ex.reason)
            except Exception:  # noqa: BLE001 — non-JSON error body
                msg = ex.reason
            raise AuthError(
                f"Error connecting to auth service: {ex.code} {msg}")
        except (urllib.error.URLError, OSError, ValueError) as ex:
            raise AuthError(f"Error connecting to auth service: {ex}")
        user = body.get("user_id")
        if not user:
            raise AuthError("auth service reply carried no user_id")
        self._cache.add_valid_token(token, user)
        return user
