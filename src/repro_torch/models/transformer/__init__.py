"""The transformer zoo: the ``dense`` and ``ssm`` families, serving path
(``model.forward`` / ``prefill`` / ``decode_step``)."""
