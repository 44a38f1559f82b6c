"""The app's end-to-end benchmark client (reference: scripts/benchmark/)."""
