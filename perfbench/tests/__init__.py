"""The benchmark's own CPU tests (and its card tests, marked gpu)."""
