"""The analysis layer (port of ``vfisr_tpu/analysis/``): statistics,
normalisation, the interval-grouped analysis of ``experiment_results.json``
and ``data_analysis.py``'s rankings, Pareto frontier, report and figures
(numpy and plain Python; matplotlib only for the figures, on call)."""
