"""Command-line apps of the port: ``generate`` (REPL), ``benchmark`` (a
dataset run with quality and speed metrics) and ``correctness`` (greedy
self-speculative == AR), over ``loading.load_model_and_tokenizer``. Each
runs on the card unless ``--device cpu`` is given."""
