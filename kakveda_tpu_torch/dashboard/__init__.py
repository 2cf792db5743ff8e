"""Dashboard application layer.

Capability parity with the reference dashboard
(reference: services/dashboard/ — app.py, db.py, auth.py, rbac.py,
templates/): auth + RBAC, scenario runner, runs explorer with span
waterfalls, warnings analytics, per-app health, datasets/evaluations,
prompt library, experiments, playground, external-agent registry, projects
with API keys and budgets, admin. Built on aiohttp + stdlib sqlite3 +
jinja2 (no FastAPI/SQLAlchemy/passlib; auth crypto is stdlib
hashlib/hmac).

The port's own copy of ``kakveda_tpu/dashboard/`` (its modules and its 28
templates) over the port's ``Platform`` and model runtimes: the scenario
runner's warns and the dataset eval's ``warn_batch`` reach ``fused_topk``
on the card, the playground's ``generate`` / ``generate_stream`` and the
eval's ``generate_batch`` the flash kernels under
``KAKVEDA_MODEL_RUNTIME=torch``. It imports nothing of the JAX package.
Where the reference calls ``httpx`` (an agent's ``/health`` and
``/invoke``) the port calls ``core/httpjson``; only the text of an agent
error differs. ``jinja2`` is required (a requirement of the torch wheel).
"""
