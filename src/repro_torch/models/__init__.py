"""Model assembly: decoder-only LM stages (``lm``) and the public
``build_model`` bundle (``api``)."""
