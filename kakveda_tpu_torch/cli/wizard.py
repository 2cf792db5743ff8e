"""Interactive setup wizard for ``python -m kakveda_tpu_torch.cli init --wizard``.

The port's copy of ``kakveda_tpu/cli/wizard.py`` (the stdlib only), which
writes the same ``.env``: parity with the reference CLI's .env wizard
(reference: kakveda_cli/config.py:40-93, kakveda_cli/prompts.py:62-144).
It asks the deployment questions, generates a real JWT secret, and writes a
``.env`` that ``up``, ``doctor`` and ``status`` load into the environment
(see :func:`load_dotenv`). Every question has a sensible default so
Enter-through-everything yields a working dev setup; ``--yes`` takes all
defaults without prompting. The runtime answer ``tpu`` selects the port's
``torch`` runtime (``models/runtime.get_runtime``).
"""

from __future__ import annotations

import os
import secrets
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple


def load_dotenv(path: Path) -> int:
    """Load KEY=VALUE lines into os.environ (real env wins). Returns the
    number of keys applied. The server reads config from the environment
    only, so without this the wizard's answers would be silently ignored
    outside docker compose."""
    if not path.exists():
        return 0
    applied = 0
    for line in path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, value = line.split("=", 1)
        key = key.strip()
        if key and key not in os.environ:
            os.environ[key] = value.strip()
            applied += 1
    return applied


def _ask(prompt: str, default: str, input_fn: Callable[[str], str]) -> str:
    raw = input_fn(f"{prompt} [{default}]: ").strip()
    return raw or default


def _ask_choice(
    prompt: str, default: str, choices: Tuple[str, ...], input_fn: Callable[[str], str]
) -> str:
    """Ask until the (case-insensitive) answer is one of ``choices`` — a
    typo like 'prod' must not silently disable production enforcement."""
    while True:
        raw = _ask(prompt, default, input_fn).strip().lower()
        if raw in choices:
            return raw
        print(f"  please answer one of: {', '.join(choices)}")


def build_env(answers: dict) -> str:
    lines = [
        "# kakveda-tpu environment — generated by `kakveda-tpu init --wizard`",
        f"KAKVEDA_ENV={answers['env']}",
        f"DASHBOARD_JWT_SECRET={answers['jwt_secret']}",
        f"KAKVEDA_MODEL_RUNTIME={answers['model_runtime']}",
        f"KAKVEDA_LOG_FORMAT={answers['log_format']}",
        f"KAKVEDA_INDEX_CAPACITY={answers['index_capacity']}",
        f"KAKVEDA_MESH_SHAPE={answers['mesh_shape']}",
    ]
    if answers.get("hf_ckpt"):
        lines.append(f"KAKVEDA_HF_CKPT={answers['hf_ckpt']}")
    if answers.get("redis_url"):
        lines.append(f"KAKVEDA_REDIS_URL={answers['redis_url']}")
    if answers.get("smtp_host"):
        lines += [
            f"SMTP_HOST={answers['smtp_host']}",
            f"SMTP_PORT={answers.get('smtp_port', '587')}",
            f"SMTP_USER={answers.get('smtp_user', '')}",
            f"SMTP_PASS={answers.get('smtp_pass', '')}",
            f"SMTP_FROM={answers.get('smtp_from', 'noreply@localhost')}",
        ]
    if answers.get("otel_endpoint"):
        lines += [
            "KAKVEDA_OTEL_ENABLED=1",
            f"OTEL_EXPORTER_OTLP_ENDPOINT={answers['otel_endpoint']}",
        ]
    return "\n".join(lines) + "\n"


def run_wizard(
    root: Path,
    *,
    assume_yes: bool = False,
    input_fn: Callable[[str], str] = input,
    print_fn: Callable[[str], None] = print,
) -> Path:
    """Ask the setup questions (or take defaults) and write ``root/.env``.

    Returns the path written. Refuses to overwrite an existing .env unless
    the user confirms (always keeps it with ``assume_yes`` — regenerating
    the JWT secret would invalidate every session).
    """
    env_path = root / ".env"
    if env_path.exists():
        if assume_yes:
            print_fn(f"keeping existing {env_path} (it holds your JWT secret)")
            return env_path
        if _ask("A .env already exists — overwrite? (y/N)", "n", input_fn).lower() != "y":
            print_fn("keeping existing .env")
            return env_path

    # (key, prompt, default, allowed-choices-or-None)
    questions: List[Tuple[str, str, str, Optional[Tuple[str, ...]]]] = [
        ("env", "Environment (development|production)", "development", ("development", "production")),
        ("model_runtime", "Model runtime (stub|tpu)", "stub", ("stub", "tpu")),
        ("hf_ckpt", "HF Llama checkpoint dir for runtime=tpu (empty = built-in tiny model)", "", None),
        ("log_format", "Log format (json|text)", "json", ("json", "text")),
        ("index_capacity", "GFKB index capacity (rows)", str(1 << 20), None),
        ("mesh_shape", "Device mesh shape", "data:-1", None),
        ("redis_url", "Redis URL (empty = in-memory revocation/rate-limit)", "", None),
        ("smtp_host", "SMTP host for password-reset email (empty = demo links)", "", None),
        ("otel_endpoint", "OTLP endpoint for OpenTelemetry (empty = disabled)", "", None),
    ]
    answers: Dict[str, str] = {}
    for key, prompt, default, choices in questions:
        if assume_yes:
            answers[key] = default
        elif choices is not None:
            answers[key] = _ask_choice(prompt, default, choices, input_fn)
        else:
            answers[key] = _ask(prompt, default, input_fn)
    if not answers["index_capacity"].isdigit():
        print_fn(f"  index capacity {answers['index_capacity']!r} is not a number; using {1 << 20}")
        answers["index_capacity"] = str(1 << 20)
    if answers.get("smtp_host") and not assume_yes:
        answers["smtp_port"] = _ask("SMTP port", "587", input_fn)
        answers["smtp_user"] = _ask("SMTP user", "", input_fn)
        answers["smtp_pass"] = _ask("SMTP password", "", input_fn)
        answers["smtp_from"] = _ask("From address", "noreply@localhost", input_fn)

    # Always generate a real secret — the server refuses the dev default in
    # production, and nobody should type their own.
    answers["jwt_secret"] = secrets.token_hex(32)

    # 0600: the file holds the JWT secret (session-forgery material) and
    # possibly an SMTP password.
    fd = os.open(env_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "w") as f:
        f.write(build_env(answers))
    print_fn(f"wrote {env_path} (JWT secret generated, mode 0600)")
    if answers["env"] == "production":
        print_fn("production mode: demo users are skipped and the JWT secret is enforced")
    return env_path
