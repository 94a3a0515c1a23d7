"""The tol-driven fidelity studies of the port (counterparts of the JAX
package's ``scripts/convergence_run.py``, ``scripts/bench_tol.py``,
``scripts/jk_fidelity_study.py`` and ``scripts/bench_external_cpd.py``,
one module each under the script's name). Each runs as
``python -m cp_cals_tpu_torch.studies.<name>``, on the CUDA card unless
``--device cpu`` is given, with the script's stages, flags, file names and
keys, and writes into ``utils/analysis.DEFAULT_BENCH_DIR``, where
``benchmark_dashboard`` reads them."""
