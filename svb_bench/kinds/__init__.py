"""One module per traffic kind; a traffic file names its kind, and the
harness runs ``kinds.<kind>.run(ctx)``."""
