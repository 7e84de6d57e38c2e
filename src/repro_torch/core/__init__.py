"""Serving core of the port: paged KV pools, scoring, compression,
sampling, the host scheduler and the engine (``repro.core``)."""
