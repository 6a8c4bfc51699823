"""Core: the error hierarchy, the CUDA device probe, the fault injector and
classifiers, the integrity plane, the trimmed telemetry (metric registry,
flight recorder), and the stage layer's base — params, the column schema,
stages and pipelines, stage serialization and the namespaced loggers."""
