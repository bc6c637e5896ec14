"""How a closed-loop cell calls the program: one module per entry point,
named by the ``entry`` key of the cell's traffic file. Each module has
``setup``, ``call``, ``keep``, ``inputs`` and ``control``."""
