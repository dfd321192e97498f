"""The analysis layer (port of ``vfisr_tpu/analysis/``): statistics,
normalisation and the interval-grouped analysis of ``experiment_results.json``.
``data_analysis.py`` (pandas, matplotlib) is not ported."""
