"""Dashboard persistence: sqlite (default) or Postgres behind one DAO.

Table-for-table parity with the reference's 22 SQLAlchemy models + its
hand-rolled ALTER-based migrate_db (reference: services/dashboard/db.py:
25-362 models, 364-644 migrations). The default backend is stdlib sqlite3
with WAL journaling; setting ``KAKVEDA_DB_URL=postgresql://…`` routes the
SAME route-layer SQL through Postgres (the reference's prod compose runs
Postgres, docker-compose.prod.yml) — the thin dialect shim below rewrites
the three divergences (qmark params, AUTOINCREMENT, INSERT OR IGNORE)
instead of dragging in an ORM.

Connections are per-call (cheap for sqlite, and it avoids cross-thread
sharing issues under aiohttp's executor; Postgres callers who need more
than the dashboard's modest QPS can front it with pgbouncer).

The port's copy of ``kakveda_tpu/dashboard/db.py``.
"""

from __future__ import annotations

import json
import os
import re
import sqlite3
import time
import uuid
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS users (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  email TEXT UNIQUE NOT NULL,
  password_hash TEXT NOT NULL,
  display_name TEXT,
  is_active INTEGER NOT NULL DEFAULT 1,
  created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS roles (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL
);
CREATE TABLE IF NOT EXISTS user_roles (
  user_id INTEGER NOT NULL,
  role_id INTEGER NOT NULL,
  PRIMARY KEY (user_id, role_id)
);
CREATE TABLE IF NOT EXISTS password_reset_tokens (
  token TEXT PRIMARY KEY,
  user_id INTEGER NOT NULL,
  expires_at REAL NOT NULL,
  used INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS audit_events (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  ts REAL NOT NULL,
  user_email TEXT,
  action TEXT NOT NULL,
  detail TEXT
);
CREATE TABLE IF NOT EXISTS projects (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS project_members (
  project_id INTEGER NOT NULL,
  user_id INTEGER NOT NULL,
  role TEXT NOT NULL DEFAULT 'member',
  PRIMARY KEY (project_id, user_id)
);
CREATE TABLE IF NOT EXISTS project_api_keys (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  project_id INTEGER NOT NULL,
  key_hash TEXT UNIQUE NOT NULL,
  label TEXT,
  created_at REAL NOT NULL,
  revoked INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS project_budgets (
  project_id INTEGER PRIMARY KEY,
  monthly_budget_micro_usd INTEGER NOT NULL DEFAULT 0,
  spent_micro_usd INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS agent_registry (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  base_url TEXT NOT NULL,
  auth_kind TEXT,           -- none | bearer_env | api_key_env
  auth_secret_env TEXT,     -- env var name holding the secret (never the secret)
  enabled INTEGER NOT NULL DEFAULT 1,
  last_heartbeat REAL,
  created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS scenario_runs (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  ts REAL NOT NULL,
  user_email TEXT,
  app_id TEXT NOT NULL,
  prompt TEXT NOT NULL,
  response TEXT,
  warning_action TEXT,
  warning_confidence REAL,
  provider TEXT,
  model TEXT,
  latency_ms INTEGER
);
CREATE TABLE IF NOT EXISTS warning_events (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  ts REAL NOT NULL,
  app_id TEXT NOT NULL,
  action TEXT NOT NULL,
  confidence REAL NOT NULL,
  pattern_id TEXT,
  failure_id TEXT,
  failure_type TEXT,
  message TEXT,
  source TEXT NOT NULL DEFAULT 'scenario'
);
CREATE TABLE IF NOT EXISTS trace_runs (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  trace_id TEXT UNIQUE NOT NULL,
  ts REAL NOT NULL,
  app_id TEXT NOT NULL,
  agent_id TEXT,
  project_id INTEGER,
  prompt TEXT,
  response TEXT,
  provider TEXT,
  model TEXT,
  latency_ms INTEGER,
  tokens_in INTEGER,
  tokens_out INTEGER,
  cost_micro_usd INTEGER,
  status TEXT NOT NULL DEFAULT 'ok',
  error TEXT
);
CREATE TABLE IF NOT EXISTS trace_spans (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  trace_id TEXT NOT NULL,
  parent_id INTEGER,
  name TEXT NOT NULL,
  start_ts REAL NOT NULL,
  end_ts REAL NOT NULL,
  meta_json TEXT
);
CREATE TABLE IF NOT EXISTS run_feedback (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  trace_id TEXT NOT NULL,
  user_email TEXT,
  thumb TEXT,               -- up | down
  label TEXT,
  note TEXT,
  ts REAL NOT NULL,
  UNIQUE (trace_id, user_email, thumb)
);
CREATE TABLE IF NOT EXISTS prompt_library (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  description TEXT,
  created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS prompt_versions (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  prompt_id INTEGER NOT NULL,
  version INTEGER NOT NULL,
  text TEXT NOT NULL,
  created_at REAL NOT NULL,
  UNIQUE (prompt_id, version)
);
CREATE TABLE IF NOT EXISTS experiments (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  description TEXT,
  created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS experiment_runs (
  experiment_id INTEGER NOT NULL,
  trace_id TEXT NOT NULL,
  PRIMARY KEY (experiment_id, trace_id)
);
CREATE TABLE IF NOT EXISTS datasets (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  description TEXT,
  created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS dataset_examples (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  dataset_id INTEGER NOT NULL,
  app_id TEXT NOT NULL DEFAULT 'eval-app',
  prompt TEXT NOT NULL,
  expected TEXT
);
CREATE TABLE IF NOT EXISTS evaluation_runs (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  dataset_id INTEGER NOT NULL,
  ts REAL NOT NULL,
  user_email TEXT,
  total INTEGER NOT NULL DEFAULT 0,
  passed INTEGER NOT NULL DEFAULT 0,
  status TEXT NOT NULL DEFAULT 'done'
);
CREATE TABLE IF NOT EXISTS evaluation_results (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  eval_run_id INTEGER NOT NULL,
  example_id INTEGER NOT NULL,
  trace_id TEXT,
  passed INTEGER NOT NULL,
  detail TEXT,
  latency_ms INTEGER,
  provider TEXT
);
CREATE INDEX IF NOT EXISTS idx_trace_runs_ts ON trace_runs (ts);
CREATE INDEX IF NOT EXISTS idx_trace_runs_app ON trace_runs (app_id);
CREATE INDEX IF NOT EXISTS idx_warning_events_ts ON warning_events (ts);
CREATE INDEX IF NOT EXISTS idx_spans_trace ON trace_spans (trace_id);
CREATE INDEX IF NOT EXISTS idx_audit_ts ON audit_events (ts);
"""

# Columns added after initial release ship as idempotent ALTERs, mirroring
# the reference's migrate_db approach (reference: services/dashboard/db.py:368-644).
_MIGRATIONS: List[str] = [
    "ALTER TABLE trace_runs ADD COLUMN tags_json TEXT",
    "ALTER TABLE scenario_runs ADD COLUMN trace_id TEXT",
    "ALTER TABLE agent_registry ADD COLUMN capabilities_json TEXT",
]


class Database:
    def __init__(self, path: str | Path):
        self.path = str(path)
        if self.path != ":memory:":
            Path(self.path).parent.mkdir(parents=True, exist_ok=True)
        self._memory_conn: Optional[sqlite3.Connection] = None
        if self.path == ":memory:":
            self._memory_conn = self._open()
        self.init()

    def _open(self) -> sqlite3.Connection:
        conn = sqlite3.connect(self.path, timeout=10.0)
        conn.row_factory = sqlite3.Row
        conn.execute("PRAGMA journal_mode=WAL")
        conn.execute("PRAGMA foreign_keys=ON")
        return conn

    def connect(self) -> sqlite3.Connection:
        return self._memory_conn if self._memory_conn is not None else self._open()

    def _close(self, conn: sqlite3.Connection) -> None:
        if conn is not self._memory_conn:
            conn.close()

    def init(self) -> None:
        conn = self.connect()
        try:
            conn.executescript(_SCHEMA)
            for stmt in _MIGRATIONS:
                try:
                    conn.execute(stmt)
                except sqlite3.OperationalError:
                    pass  # column already exists — idempotent by design
            conn.commit()
        finally:
            self._close(conn)

    # --- tiny DAO helpers ------------------------------------------------

    def execute(self, sql: str, params: Iterable[Any] = ()) -> int:
        """Run a statement; returns the inserted rowid (INSERTs only —
        sqlite keeps ``lastrowid`` stale across non-INSERT statements on a
        shared connection, so use :meth:`execute_rowcount` when the caller
        needs matched-row semantics)."""
        conn = self.connect()
        try:
            cur = conn.execute(sql, tuple(params))
            conn.commit()
            return cur.lastrowid or 0
        finally:
            self._close(conn)

    def execute_rowcount(self, sql: str, params: Iterable[Any] = ()) -> int:
        """Run a statement; returns the number of matched/affected rows."""
        conn = self.connect()
        try:
            cur = conn.execute(sql, tuple(params))
            conn.commit()
            return cur.rowcount
        finally:
            self._close(conn)

    def query(self, sql: str, params: Iterable[Any] = ()) -> List[Dict[str, Any]]:
        conn = self.connect()
        try:
            rows = conn.execute(sql, tuple(params)).fetchall()
            return [dict(r) for r in rows]
        finally:
            self._close(conn)

    def one(self, sql: str, params: Iterable[Any] = ()) -> Optional[Dict[str, Any]]:
        rows = self.query(sql, params)
        return rows[0] if rows else None

    # --- bootstrap -------------------------------------------------------

    def bootstrap(self, *, demo_users: bool = True) -> None:
        """Roles + self-repairing demo users
        (reference: services/dashboard/app.py:1273-1329)."""
        from kakveda_tpu_torch.dashboard.auth import hash_password

        for role in ("admin", "operator", "viewer"):
            self.execute("INSERT OR IGNORE INTO roles (name) VALUES (?)", (role,))
        if not demo_users:
            return
        demo = [
            ("admin@local", "admin123", "Admin", "admin"),
            ("operator@local", "operator123", "Operator", "operator"),
            ("viewer@local", "viewer123", "Viewer", "viewer"),
        ]
        for email, pw, name, role in demo:
            user = self.one("SELECT id FROM users WHERE email=?", (email,))
            if user is None:
                uid = self.execute(
                    "INSERT INTO users (email, password_hash, display_name, is_active, created_at)"
                    " VALUES (?,?,?,1,?)",
                    (email, hash_password(pw), name, time.time()),
                )
            else:
                uid = user["id"]
                # self-repair: demo accounts always reactivate with known creds
                self.execute(
                    "UPDATE users SET password_hash=?, is_active=1 WHERE id=?",
                    (hash_password(pw), uid),
                )
            rid = self.one("SELECT id FROM roles WHERE name=?", (role,))["id"]
            self.execute(
                "INSERT OR IGNORE INTO user_roles (user_id, role_id) VALUES (?,?)", (uid, rid)
            )

    # --- common lookups --------------------------------------------------

    def user_by_email(self, email: str) -> Optional[Dict[str, Any]]:
        return self.one("SELECT * FROM users WHERE email=?", (email,))

    def user_roles(self, user_id: int) -> List[str]:
        rows = self.query(
            "SELECT r.name FROM roles r JOIN user_roles ur ON ur.role_id=r.id WHERE ur.user_id=?",
            (user_id,),
        )
        return [r["name"] for r in rows]

    def audit(self, user_email: Optional[str], action: str, detail: Any = None) -> None:
        self.execute(
            "INSERT INTO audit_events (ts, user_email, action, detail) VALUES (?,?,?,?)",
            (time.time(), user_email, action, json.dumps(detail) if detail is not None else None),
        )

    def add_span(
        self,
        trace_id: str,
        name: str,
        start_ts: float,
        end_ts: float,
        parent_id: Optional[int] = None,
        meta: Optional[dict] = None,
    ) -> int:
        return self.execute(
            "INSERT INTO trace_spans (trace_id, parent_id, name, start_ts, end_ts, meta_json)"
            " VALUES (?,?,?,?,?,?)",
            (trace_id, parent_id, name, start_ts, end_ts, json.dumps(meta or {})),
        )


# --- Postgres backend ------------------------------------------------------

# Tables without a surrogate ``id`` column — INSERTs into these skip the
# RETURNING clause the Postgres path uses in place of sqlite's lastrowid.
_IDLESS_TABLES = frozenset(
    {"user_roles", "project_members", "experiment_runs", "project_budgets",
     "password_reset_tokens"}
)

_INSERT_RE = re.compile(r"^\s*INSERT\s+(OR\s+IGNORE\s+)?INTO\s+(\w+)", re.IGNORECASE)


def pg_translate(sql: str) -> str:
    """Route-layer (sqlite-flavored) SQL → Postgres. Only the constructs
    this codebase uses: qmark params and INSERT OR IGNORE."""
    m = _INSERT_RE.match(sql)
    ignore = bool(m and m.group(1))
    if ignore:
        sql = re.sub(
            r"INSERT\s+OR\s+IGNORE\s+INTO", "INSERT INTO", sql, count=1, flags=re.IGNORECASE
        )
    out = sql.replace("?", "%s")
    if ignore:
        out += " ON CONFLICT DO NOTHING"
    return out


def pg_schema(schema_sql: str) -> List[str]:
    """The shared DDL → Postgres statements (AUTOINCREMENT → BIGSERIAL)."""
    ddl = schema_sql.replace("INTEGER PRIMARY KEY AUTOINCREMENT", "BIGSERIAL PRIMARY KEY")
    return [s.strip() for s in ddl.split(";") if s.strip()]


class PgDatabase:
    """Same DAO surface as :class:`Database`, speaking Postgres.

    Gated on psycopg2 being importable — the client library is not vendored; the
    prod compose image installs it (docker-compose.prod.yml)."""

    def __init__(self, url: str):
        try:
            import psycopg2  # noqa: F401
            import psycopg2.extras  # noqa: F401
        except ImportError as e:  # pragma: no cover - present in the prod image
            raise RuntimeError(
                "KAKVEDA_DB_URL points at Postgres but psycopg2 is not "
                "installed; pip install psycopg2-binary (the prod compose "
                "image does) or unset KAKVEDA_DB_URL for sqlite"
            ) from e
        self.url = url
        self.path = url  # parity with Database.path for logs/doctor
        self.init()

    def connect(self):
        import psycopg2
        import psycopg2.extras

        return psycopg2.connect(self.url, cursor_factory=psycopg2.extras.RealDictCursor)

    def init(self) -> None:
        conn = self.connect()
        try:
            with conn.cursor() as cur:
                for stmt in pg_schema(_SCHEMA):
                    cur.execute(stmt)
            conn.commit()
            for stmt in _MIGRATIONS:
                try:
                    with conn.cursor() as cur:
                        cur.execute(pg_translate(stmt))
                    conn.commit()
                except Exception:  # noqa: BLE001 — column exists: idempotent
                    conn.rollback()
        finally:
            conn.close()

    def execute(self, sql: str, params: Iterable[Any] = ()) -> int:
        tr = pg_translate(sql)
        m = _INSERT_RE.match(sql)
        want_id = bool(m) and m.group(2).lower() not in _IDLESS_TABLES and "RETURNING" not in tr.upper()
        if want_id:
            tr += " RETURNING id"
        conn = self.connect()
        try:
            with conn.cursor() as cur:
                cur.execute(tr, tuple(params))
                rid = 0
                if want_id:
                    row = cur.fetchone()
                    rid = int(row["id"]) if row else 0
            conn.commit()
            return rid
        finally:
            conn.close()

    def execute_rowcount(self, sql: str, params: Iterable[Any] = ()) -> int:
        conn = self.connect()
        try:
            with conn.cursor() as cur:
                cur.execute(pg_translate(sql), tuple(params))
                rc = cur.rowcount
            conn.commit()
            return rc
        finally:
            conn.close()

    def query(self, sql: str, params: Iterable[Any] = ()) -> List[Dict[str, Any]]:
        conn = self.connect()
        try:
            with conn.cursor() as cur:
                cur.execute(pg_translate(sql), tuple(params))
                return [dict(r) for r in cur.fetchall()]
        finally:
            conn.close()

    def one(self, sql: str, params: Iterable[Any] = ()) -> Optional[Dict[str, Any]]:
        rows = self.query(sql, params)
        return rows[0] if rows else None

    # Shared helpers are identical SQL-wise — reuse Database's implementations.
    bootstrap = Database.bootstrap
    user_by_email = Database.user_by_email
    user_roles = Database.user_roles
    audit = Database.audit
    add_span = Database.add_span


def make_database(path: str | Path):
    """sqlite at ``path`` unless KAKVEDA_DB_URL selects Postgres — one env
    var flips the whole dashboard, no route changes."""
    url = os.environ.get("KAKVEDA_DB_URL", "").strip()
    if url.startswith(("postgres://", "postgresql://")):
        return PgDatabase(url)
    return Database(path)


def new_trace_id() -> str:
    return str(uuid.uuid4())
