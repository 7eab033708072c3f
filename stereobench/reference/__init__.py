"""Plain float32 references of the benchmark's networks, one module a network
(``fast``, ``classic``), each with ``forward(params, left, right, model)``.
They import nothing of the program under test."""
