"""Business-logic services over the engine and the database."""
