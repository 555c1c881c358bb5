"""Flag parsing of the port's CLI modes."""
