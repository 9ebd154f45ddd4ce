"""Distribution-strategy case suite, written in torch on the SPMD shim."""
