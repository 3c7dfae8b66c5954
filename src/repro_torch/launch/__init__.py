"""Command-line drivers (reference: ``src/repro/launch``): ``serve`` and
``train``.  The mesh, step-building and dry-run drivers wait for
ROADMAP.md queue 1 item 13."""
