"""The component profiles and kernel A/Bs of the port (counterparts of the
JAX package's ``scripts/profile_iteration.py``, ``profile_ablation.py``,
``profile_epilogue_ab.py``, ``profile_update_variants.py``,
``bench_pallas_ab.py`` and ``tune_pallas_mttkrp.py``, one module each
under the script's name). Each runs as
``python -m cp_cals_tpu_torch.profiles.<name>``, on the CUDA card unless
``--device cpu`` is given, with the script's flags and output keys, and
writes into ``chiprun_out/profiles/`` (``_timing.OUT_DIR``). How a body is
timed, and what differs from the scripts, is in ``_timing``."""
