"""Database schema (migrations) for the control plane.

Reference parity: the 9 SQLAlchemy models at
backend/app/models.py:28-205 (User, Store, Document with
status machine, QueryLog cost ledger, Budget, AdminAuditLog, ChatSession,
ChatHistory, AppSetting) and its 16 Alembic migrations, collapsed into
ordered SQL scripts applied via PRAGMA user_version
(rag_foundation_tpu_torch.runtime.db.Database.migrate).
"""

from __future__ import annotations

# Document status machine (reference models.py:78-125)
DOC_PENDING = "PENDING"
DOC_RUNNING = "RUNNING"
DOC_DONE = "DONE"
DOC_ERROR = "ERROR"

MIGRATIONS: list[str] = [
    # 0001 initial schema
    """
    CREATE TABLE users (
      id INTEGER PRIMARY KEY AUTOINCREMENT,
      email TEXT NOT NULL UNIQUE,
      password_hash TEXT NOT NULL,
      role TEXT NOT NULL DEFAULT 'user',          -- user|admin
      is_active INTEGER NOT NULL DEFAULT 1,
      created_at REAL NOT NULL
    );
    CREATE TABLE stores (
      id INTEGER PRIMARY KEY AUTOINCREMENT,
      user_id INTEGER NOT NULL REFERENCES users(id),
      name TEXT NOT NULL,
      engine_key TEXT NOT NULL UNIQUE,            -- fs_name analog
      created_at REAL NOT NULL,
      deleted_at REAL                              -- soft delete
    );
    CREATE INDEX stores_user ON stores(user_id, deleted_at);
    CREATE TABLE documents (
      id INTEGER PRIMARY KEY AUTOINCREMENT,
      store_id INTEGER NOT NULL REFERENCES stores(id),
      user_id INTEGER NOT NULL REFERENCES users(id),
      filename TEXT NOT NULL,
      content_type TEXT NOT NULL DEFAULT '',
      size_bytes INTEGER NOT NULL DEFAULT 0,
      status TEXT NOT NULL DEFAULT 'PENDING',     -- PENDING|RUNNING|DONE|ERROR
      status_updated_at REAL NOT NULL,
      op_name TEXT,                                -- ingestion op handle
      engine_doc_id TEXT,                          -- gemini_file_id analog
      archive_path TEXT,                           -- gcs_uri analog
      last_error TEXT,
      est_tokens INTEGER NOT NULL DEFAULT 0,
      chunks INTEGER NOT NULL DEFAULT 0,
      created_at REAL NOT NULL,
      deleted_at REAL
    );
    CREATE INDEX documents_store ON documents(store_id, deleted_at);
    CREATE INDEX documents_status ON documents(status, status_updated_at);
    CREATE TABLE query_log (
      id INTEGER PRIMARY KEY AUTOINCREMENT,
      user_id INTEGER NOT NULL REFERENCES users(id),
      store_id INTEGER,
      model TEXT NOT NULL,                         -- model name or 'INDEX'
      prompt_tokens INTEGER NOT NULL DEFAULT 0,
      completion_tokens INTEGER NOT NULL DEFAULT 0,
      cost_usd TEXT NOT NULL DEFAULT '0',          -- Decimal as text
      status TEXT NOT NULL DEFAULT 'ok',           -- ok|error|over_budget
      created_at REAL NOT NULL
    );
    CREATE INDEX query_log_user_time ON query_log(user_id, created_at);
    CREATE TABLE budgets (
      user_id INTEGER PRIMARY KEY REFERENCES users(id),
      monthly_usd TEXT NOT NULL,
      updated_at REAL NOT NULL
    );
    CREATE TABLE admin_audit_log (
      id INTEGER PRIMARY KEY AUTOINCREMENT,
      admin_user_id INTEGER NOT NULL REFERENCES users(id),
      action TEXT NOT NULL,
      target TEXT NOT NULL DEFAULT '',
      detail TEXT NOT NULL DEFAULT '',
      created_at REAL NOT NULL
    );
    CREATE TABLE chat_sessions (
      id INTEGER PRIMARY KEY AUTOINCREMENT,
      user_id INTEGER NOT NULL REFERENCES users(id),
      store_id INTEGER,
      title TEXT NOT NULL DEFAULT '',
      created_at REAL NOT NULL,
      updated_at REAL NOT NULL
    );
    CREATE INDEX chat_sessions_user ON chat_sessions(user_id, updated_at);
    CREATE TABLE chat_history (
      id INTEGER PRIMARY KEY AUTOINCREMENT,
      session_id INTEGER NOT NULL REFERENCES chat_sessions(id),
      user_id INTEGER NOT NULL REFERENCES users(id),
      role TEXT NOT NULL,                          -- user|assistant
      content TEXT NOT NULL,
      created_at REAL NOT NULL
    );
    CREATE INDEX chat_history_session ON chat_history(session_id, id);
    CREATE TABLE app_settings (
      key TEXT PRIMARY KEY,
      value TEXT NOT NULL,
      updated_at REAL NOT NULL
    );
    """,
    # 002: request tags on the cost ledger (reference QueryLog carries
    # per-request tags; chat.py:713-755)
    """
    ALTER TABLE query_log ADD COLUMN tags TEXT;
    """,
    # 003: free-form admin notes on users (reference models.py:36 +
    # routes/admin.py:78 — editable from the admin user modal)
    """
    ALTER TABLE users ADD COLUMN admin_notes TEXT;
    """,
]
