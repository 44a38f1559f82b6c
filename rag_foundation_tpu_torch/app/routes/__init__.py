"""HTTP route modules; each exposes ``register(app, ctx)``."""
