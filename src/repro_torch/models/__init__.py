"""Model code of the port: blocks, the SSM head block and the LM."""
