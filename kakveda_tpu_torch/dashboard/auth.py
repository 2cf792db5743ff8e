"""Auth crypto on the stdlib: pbkdf2 password hashing + HS256 JWT.

Same guarantees as the reference's passlib/pyjwt stack
(reference: services/dashboard/auth.py:30-58): salted pbkdf2_sha256
password hashes, HS256 tokens with iss/jti/exp claims (default TTL 720
minutes), and single-use reset tokens — implemented with hashlib/hmac/
base64/json, with no third-party wheel.

The port's copy of ``kakveda_tpu/dashboard/auth.py``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import secrets
import time
from typing import Any, Dict, Optional

ISSUER = "kakveda-tpu"
TOKEN_TTL_MINUTES = int(os.environ.get("DASHBOARD_TOKEN_TTL_MINUTES", "720"))
_PBKDF2_ITERATIONS = 390_000


# --- passwords -------------------------------------------------------------


def hash_password(password: str) -> str:
    salt = secrets.token_bytes(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode("utf-8"), salt, _PBKDF2_ITERATIONS)
    return f"pbkdf2_sha256${_PBKDF2_ITERATIONS}${salt.hex()}${dk.hex()}"


def verify_password(password: str, stored: str) -> bool:
    try:
        scheme, iters, salt_hex, dk_hex = stored.split("$")
        if scheme != "pbkdf2_sha256":
            return False
        dk = hashlib.pbkdf2_hmac(
            "sha256", password.encode("utf-8"), bytes.fromhex(salt_hex), int(iters)
        )
        return hmac.compare_digest(dk.hex(), dk_hex)
    except (ValueError, TypeError):
        return False


# --- JWT (HS256) -----------------------------------------------------------


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _b64url_decode(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def create_access_token(
    *,
    email: str,
    roles: list[str],
    secret: str,
    ttl_minutes: int = TOKEN_TTL_MINUTES,
    extra: Optional[Dict[str, Any]] = None,
) -> str:
    now = int(time.time())
    payload: Dict[str, Any] = {
        "iss": ISSUER,
        "sub": email,
        "roles": roles,
        "jti": secrets.token_hex(16),
        "iat": now,
        "exp": now + ttl_minutes * 60,
    }
    if extra:
        payload.update(extra)
    header = {"alg": "HS256", "typ": "JWT"}
    signing_input = f"{_b64url(json.dumps(header, separators=(',', ':')).encode())}." \
                    f"{_b64url(json.dumps(payload, separators=(',', ':')).encode())}"
    sig = hmac.new(secret.encode(), signing_input.encode(), hashlib.sha256).digest()
    return f"{signing_input}.{_b64url(sig)}"


def decode_token(token: str, *, secret: str) -> Optional[Dict[str, Any]]:
    """Validated claims dict, or None for any invalid/expired/forged token."""
    try:
        h, p, s = token.split(".")
        signing_input = f"{h}.{p}"
        expected = hmac.new(secret.encode(), signing_input.encode(), hashlib.sha256).digest()
        if not hmac.compare_digest(expected, _b64url_decode(s)):
            return None
        header = json.loads(_b64url_decode(h))
        if header.get("alg") != "HS256":
            return None
        payload = json.loads(_b64url_decode(p))
        if payload.get("iss") != ISSUER:
            return None
        if int(payload.get("exp", 0)) < time.time():
            return None
        return payload
    except (ValueError, KeyError, json.JSONDecodeError):
        return None


# --- reset tokens ----------------------------------------------------------


def mint_reset_token() -> str:
    return secrets.token_urlsafe(32)
