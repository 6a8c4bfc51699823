"""Notebook-302 parity: image ingestion + ImageTransformer pipeline.

Reference flow (notebooks/samples/302 - Pipeline Image
Transformations.ipynb): spark.readImages -> sample -> ImageTransformer
resize/crop/flip/gaussian-blur chain -> inspect shapes. Here images are
written as real files, ingested through the binary reader + decode path
(the readers/ImageFileFormat analog), and run through the same op DSL.
"""

import os
import tempfile

import numpy as np

from mmlspark_tpu_torch.data.readers import read_images
from mmlspark_tpu_torch.stages.image import ImageSetAugmenter, ImageTransformer


def write_pngs(root: str, n=6) -> None:
    from PIL import Image

    rng = np.random.default_rng(0)
    for i in range(n):
        img = rng.integers(0, 256, (48 + 4 * i, 64, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, f"img{i}.png"))


def main():
    with tempfile.TemporaryDirectory() as root:
        write_pngs(root)
        ds = read_images(root)
        assert ds.num_rows == 6

        out = (
            ImageTransformer(input_col="image", output_col="small")
            .resize(32, 32)
            .crop(0, 0, 24, 24)
            .flip(1)
            .blur(3, 3)
            .transform(ds)
        )
        shapes = {row.data.shape for row in out["small"]}
        assert shapes == {(24, 24, 3)}, shapes

        aug = ImageSetAugmenter(flip_left_right=True).transform(ds)
        assert aug.num_rows == 12
        print(f"OK {{'images': {ds.num_rows}, "
              f"'transformed_shape': [24, 24, 3], "
              f"'augmented_rows': {aug.num_rows}}}")


if __name__ == "__main__":
    main()
