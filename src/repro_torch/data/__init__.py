"""Serving workloads: dataset profiles, Poisson arrivals and traces
(a copy of the JAX package's ``repro.data``)."""
