"""Role-based access control (reference: services/dashboard/rbac.py:6-18).

The port's copy of ``kakveda_tpu/dashboard/rbac.py``.
"""

from __future__ import annotations

from typing import Iterable

ADMIN = "admin"
OPERATOR = "operator"
VIEWER = "viewer"

ALL_ROLES = (ADMIN, OPERATOR, VIEWER)


def has_role(user_roles: Iterable[str], role: str) -> bool:
    return role in set(user_roles)


def require_any(user_roles: Iterable[str], allowed: Iterable[str]) -> bool:
    return bool(set(user_roles) & set(allowed))
