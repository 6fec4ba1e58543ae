"""Model assembly: decoder-only LM stages (``lm``), the encoder-decoder
family (``encdec``), the CLIP dual encoder (``clip``) and the public
``build_model`` bundle (``api``)."""
