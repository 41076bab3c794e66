"""Benchmark harness over baryonyx-format CSV suites
(reference: app/src/benchmark.cpp)."""

from baryonyx_torch.bench.harness import benchmark
