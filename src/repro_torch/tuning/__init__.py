"""The autotuner: the ``EngineSpec`` identity, tuning tables and search.

``EngineSpec`` is the one configuration identity of the port (engine
construction, runner cache keys, serving buckets, tuning-table keys);
``normalize()`` resolves its tunable knobs by

    explicit argument > tuning-table hit > static heuristic.

See ``python -m repro_torch.tuning --help``.
"""
from repro_torch.tuning.measure import (geomean, measured_bandwidth_gbs,
                                        roofline_step_seconds,
                                        time_interleaved)
from repro_torch.tuning.presets import preset_specs
from repro_torch.tuning.search import (Candidate, TuneResult,
                                       candidate_space, tune_many, tune_spec)
from repro_torch.tuning.spec import KIND_ALIASES, KINDS, EngineSpec
from repro_torch.tuning.table import (DEFAULT_TABLE_PATH, TABLE_VERSION,
                                      TableEntry, TuningTable, consult,
                                      default_table,
                                      reset_default_table_cache,
                                      tuning_enabled)

__all__ = [
    "EngineSpec", "KINDS", "KIND_ALIASES",
    "TuningTable", "TableEntry", "TABLE_VERSION", "DEFAULT_TABLE_PATH",
    "consult", "default_table", "reset_default_table_cache",
    "tuning_enabled",
    "tune_spec", "tune_many", "candidate_space", "Candidate",
    "TuneResult",
    "time_interleaved", "geomean", "roofline_step_seconds",
    "measured_bandwidth_gbs", "preset_specs",
]
