"""Runnable examples of the port (counterparts of the repo's examples/):
``python -m magphase_tpu_torch.examples.<name>`` with ``serving_on_device``,
``demo_copy_synthesis_lossless``, ``demo_copy_synthesis_low_dim``,
``run_experiment`` and ``compare_mags``.  Each runs on the card unless
given ``--device cpu``, and on synthetic speech where the demo corpus is
absent."""
