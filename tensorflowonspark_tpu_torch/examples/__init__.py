"""The port's examples, SPARK-fed and TENSORFLOW-mode.  Their
``main_fun``s live in the package, not in a driver script's
``__main__``: the engine's spawned executors import them by name."""
