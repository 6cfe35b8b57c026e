"""One module a path: ``run(cell, seed, seconds, trace, device, started)``."""
