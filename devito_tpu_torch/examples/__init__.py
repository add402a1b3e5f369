"""devito_tpu's examples through the port: the same modules, functions,
signatures, defaults and return values (``examples/`` at the root holds
devito_tpu's). They run on the card by default; set
``configuration['device'] = 'cpu'`` to run them on the CPU."""
