"""Tasks: model + data + inference loop behind the CLI."""
