"""Workload graphs, the task compiler and HLO ingestion (copies of
``repro.graph``)."""
