"""The ``mixtral`` family (HF ``MixtralForCausalLM``): the ``mistral``
family's weights, program build and FLOP count, unchanged (the same
weights bit for bit from a seed), under the name whose reference
(``reference/mixtral.py``) can follow the program's expert choices."""

from loadbench.families.mistral import engine, make_weights, model_shape, shapes  # noqa: F401
