"""Model families, one file each, named by a configuration's ``family``
key (``mistral`` where it names none): ``shapes(hf)`` and
``make_weights(hf, exit_layer, tail_eps, seed, device, dtype)``, the
weights drawn from the seed; ``engine(cell, weights, device)``, the program
under test built from them (the only place the program's model is built);
``model_shape(hf)``, the FLOP count of ``yardstick/flops.py``. The family's
plain reference is ``reference/<family>.py``."""
