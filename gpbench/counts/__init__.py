"""Per configuration: its operations and bytes, from the mathematics and the shapes."""
