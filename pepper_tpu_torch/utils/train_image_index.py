"""Merge training-image HDF5 directories into one record index — QA tool.

Role parity: reference helper/merge_train_images.py — scans every .hdf5 in
a directory, enumerates each region group's images, and writes one merged
index file mapping a global record number to "source_file,region,row", so
a training dataloader can address the union of many image-generation runs
without copying the (large) image tensors.

The port's copy of pepper_tpu/utils/train_image_index.py, with its imports
rewritten to pepper_tpu_torch.*; h5py is imported inside merge_image_index,
so importing the module needs no h5py.
"""
import argparse
import os
from typing import List


def get_hdf5_paths(directory: str) -> List[str]:
    return sorted(os.path.join(directory, f) for f in os.listdir(directory)
                  if os.path.isfile(os.path.join(directory, f))
                  and (f.endswith(".hdf5") or f.endswith(".hdf")))


def merge_image_index(input_directory: str, output_directory: str,
                      verbose: bool = True) -> str:
    import h5py

    paths = get_hdf5_paths(input_directory)
    os.makedirs(output_directory, exist_ok=True)
    out_path = os.path.join(output_directory, "Merged_file.hdf")
    record_index = 0
    with h5py.File(out_path, "w") as out:
        for i, path in enumerate(paths):
            if verbose:
                print("PROCESSING: ", i + 1, "/", len(paths))
            with h5py.File(path, "r") as fh:
                if "summaries" not in fh:
                    continue
                for region_name in fh["summaries"]:
                    n = fh["summaries"][region_name]["images"].shape[0]
                    for row in range(n):
                        out[str(record_index)] = \
                            f"{path},{region_name},{row}"
                        record_index += 1
            if verbose:
                print("TOTAL RECORDS:", record_index)
    if verbose:
        print("FILES SAVED.")
    return out_path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="pepper_merge_train_images",
        description="Index all training images across HDF5 files.")
    parser.add_argument("--image_directory", "-i", type=str, required=True,
                        help="Directory containing image hdf5 files.")
    parser.add_argument("--output_directory", "-o", type=str, required=True,
                        help="Where to write Merged_file.hdf.")
    args = parser.parse_args(argv)
    merge_image_index(args.image_directory, args.output_directory)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
