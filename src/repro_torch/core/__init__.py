"""The framework-level RegDem layer of the port (counterpart of the JAX half
of ``repro.core``): where a kernel's loop-carried state lives
(:mod:`.vmem_demotion`) and which program variant ships
(:mod:`.tpu_predictor`)."""
