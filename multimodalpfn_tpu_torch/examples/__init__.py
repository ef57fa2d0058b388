"""The port's examples, counterparts of the JAX package's ``examples/``: each
module's ``main(...)`` returns the metrics it prints and runs on the card
unless it is given ``device="cpu"``; ``python -m
multimodalpfn_tpu_torch.examples.<name>`` runs it with its defaults."""
