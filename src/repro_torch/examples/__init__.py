"""The port's examples (mirror of the reference's ``examples/``), each
run as ``python -m repro_torch.examples.<name>``:

  * ``quickstart``        — the paper's arithmetic (``--device``);
  * ``accelerator_study`` — size an MC-IPU accelerator for a model
    (numpy models, no device);
  * ``serve_lm``          — serve qwen2-0.5b under a policy, a plan or a
    fleet of replicas (``--device``);
  * ``train_lm``          — train a small LM on the Markov stream with
    the whole training stack (``--device``).
"""
