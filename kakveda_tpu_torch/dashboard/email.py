"""Best-effort SMTP email delivery (reference:
services/dashboard/app.py:67-92).

Configured entirely from env (SMTP_HOST/PORT/USER/PASS/FROM/TLS); returns
False rather than raising when unconfigured or the send fails, so callers
can fall back to demo-mode behavior (inline reset link outside production).

The port's copy of ``kakveda_tpu/dashboard/email.py``.
"""

from __future__ import annotations

import logging
import os
import smtplib
from email.message import EmailMessage

logger = logging.getLogger("kakveda.email")


def smtp_configured() -> bool:
    return bool(os.environ.get("SMTP_HOST") and os.environ.get("SMTP_USER"))


def send_email(to: str, subject: str, body: str) -> bool:
    host = os.environ.get("SMTP_HOST")
    user = os.environ.get("SMTP_USER")
    password = os.environ.get("SMTP_PASS", "")
    if not host or not user:
        return False
    port = int(os.environ.get("SMTP_PORT", "587"))
    sender = os.environ.get("SMTP_FROM", "noreply@localhost")
    use_tls = os.environ.get("SMTP_TLS", "true").lower() in ("1", "true", "yes")
    try:
        msg = EmailMessage()
        msg["From"] = sender
        msg["To"] = to
        msg["Subject"] = subject
        msg.set_content(body)
        with smtplib.SMTP(host, port, timeout=10) as s:
            if use_tls:
                s.starttls()
            s.login(user, password)
            s.send_message(msg)
        return True
    except Exception as exc:  # noqa: BLE001 — delivery is best-effort
        logger.error("SMTP send failed: %s", exc)
        return False
