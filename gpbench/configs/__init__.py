"""Per configuration: its data and the program under test (`<name>.py`),
beside its sizes (`<name>.json`)."""
